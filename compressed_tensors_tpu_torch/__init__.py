"""compressed_tensors_tpu_torch: the PyTorch/CUDA port of
compressed_tensors_tpu for NVIDIA Hopper.

It runs the compressed-tensors lifecycle (config -> calibrate -> quantize
-> compress -> save, ``quantization/lifecycle.py`` and
``ModelCompressor.save_checkpoint``) and reads and runs compressed-tensors
checkpoints run compressed, with hand-written CUDA kernels for the hot
paths (``ops/kernels/``, sources in ``csrc/``). Entry points run on the
card unless the caller passes ``device="cpu"``, where each kernel's plain
PyTorch version runs instead.

The top level re-exports the JAX package's top-level names, the offload
caches and planner among them.
"""

from compressed_tensors_tpu_torch.version import __version__  # noqa: F401
from compressed_tensors_tpu_torch.config import (  # noqa: F401
    COMPRESSION_VERSION_NAME,
    QUANTIZATION_CONFIG_NAME,
    QUANTIZATION_METHOD,
    QUANTIZATION_METHOD_NAME,
    SPARSITY_CONFIG_NAME,
    TRANSFORM_CONFIG_NAME,
    CompressionFormat,
    SparsityCompressionConfig,
    SparsityStructure,
)
from compressed_tensors_tpu_torch.quantization import (  # noqa: F401
    QuantizationArgs,
    QuantizationConfig,
    QuantizationScheme,
    QuantizationStatus,
    QuantizationStrategy,
    QuantizationType,
)
from compressed_tensors_tpu_torch.compressors import (  # noqa: F401
    COMPRESSIBLE_MODULE_TYPES,
    BaseCompressor,
    BitmaskCompressor,
    DenseCompressor,
    FloatQuantizationCompressor,
    IntQuantizationCompressor,
    ModelCompressor,
    NaiveQuantizationCompressor,
    PackedQuantizationCompressor,
    TensorStateDict,
    get_compressor,
    infer_format_from_schemes,
    infer_module_format,
    module_graph_from_names,
)
from compressed_tensors_tpu_torch.compressors.nvfp4 import (  # noqa: F401
    MXFP4PackedCompressor,
    MXFP8QuantizationCompressor,
    NVFP4PackedCompressor,
)
from compressed_tensors_tpu_torch.ops import (  # noqa: F401
    calculate_qparams,
    calculate_range,
    cast_to_fp4,
    compute_dynamic_scales_and_zp,
    dequantize,
    fake_quantize,
    generate_gparam,
    quantize,
)
from compressed_tensors_tpu_torch.ops.pack import (  # noqa: F401
    pack_to_int32,
    unpack_from_int32,
)
from compressed_tensors_tpu_torch.ops.fp4_pack import (  # noqa: F401
    pack_fp4_to_uint8,
    unpack_fp4_from_uint8,
)
from compressed_tensors_tpu_torch.ops.bitmask import (  # noqa: F401
    pack_bitmasks,
    unpack_bitmasks,
)
from compressed_tensors_tpu_torch.utils.match import (  # noqa: F401
    get_lowest_common_ancestor_name,
    is_match,
    is_narrow_match,
    match_modules_set,
    match_name,
    match_named_modules,
    match_named_parameters,
    match_quantizable_tensors,
    match_targets,
)
from compressed_tensors_tpu_torch.utils import (  # noqa: F401
    Aliasable,
    ParameterizedDefaultDict,
    combine_shards,
    getattr_chain,
    shard_tensor,
)
from compressed_tensors_tpu_torch.utils.safetensors_io import (  # noqa: F401
    get_nested_weight_mappings,
    get_quantization_config_dict,
    get_safetensors_header,
    get_weight_map,
    is_quantization_param,
    update_safetensors_index,
)
from compressed_tensors_tpu_torch.offload import (  # noqa: F401
    DeviceCache,
    DiskCache,
    HostCache,
    OffloadCache,
    disable_offloading,
    disable_onloading,
    dispatch_plan,
    max_binary_search,
)
from compressed_tensors_tpu_torch.logger import logger  # noqa: F401
from compressed_tensors_tpu_torch.flags import (  # noqa: F401
    FLAGS,
    flag_overrides,
    reload_flags_from_env,
    set_flags,
)
