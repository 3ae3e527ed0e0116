from compressed_tensors_tpu_torch.compressors.base import (  # noqa: F401
    COMPRESSIBLE_MODULE_TYPES,
    BaseCompressor,
    TensorStateDict,
    compress_state_dict,
    decompress_state_dict,
    get_compressor,
)
from compressed_tensors_tpu_torch.compressors.dense import DenseCompressor  # noqa: F401
from compressed_tensors_tpu_torch.compressors.naive_quantized import (  # noqa: F401
    FloatQuantizationCompressor,
    IntQuantizationCompressor,
    NaiveQuantizationCompressor,
)
from compressed_tensors_tpu_torch.compressors.pack_quantized import (  # noqa: F401
    PackedQuantizationCompressor,
)
from compressed_tensors_tpu_torch.compressors.nvfp4 import (  # noqa: F401
    MXFP4PackedCompressor,
    MXFP8QuantizationCompressor,
    NVFP4PackedCompressor,
)
from compressed_tensors_tpu_torch.compressors.sparse import (  # noqa: F401
    BitmaskCompressor,
    Sparse24BitMaskCompressor,
)
from compressed_tensors_tpu_torch.compressors.format import (  # noqa: F401
    COMPRESSION_FORMAT_PRIORITY,
    flatten_formats,
    infer_format_from_schemes,
    infer_module_format,
)
from compressed_tensors_tpu_torch.compressors.model_compressor import (  # noqa: F401
    ModelCompressor,
    module_graph_from_names,
    resolve_module_schemes,
)
