from compressed_tensors_tpu_torch.entrypoints.convert.convert_checkpoint import (  # noqa: F401,E501
    convert_checkpoint,
    exec_jobs,
)
from compressed_tensors_tpu_torch.entrypoints.convert.converters import (  # noqa: F401,E501
    AutoAWQConverter,
    CompressedTensorsDequantizer,
    Converter,
    FP8BlockDequantizer,
    ModelOptNvfp4Converter,
    build_inverse_weight_maps,
)
