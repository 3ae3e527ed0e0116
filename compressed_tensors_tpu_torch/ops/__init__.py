"""Compute ops of the port: the int32 codec, quantization math, quantized
linear algebra, projection fusion and the kernels."""

from compressed_tensors_tpu_torch.ops.quantize import (  # noqa: F401
    dequantize,
    fake_quantize,
    quantize,
)
from compressed_tensors_tpu_torch.ops.qparams import (  # noqa: F401
    calculate_qparams,
    calculate_range,
    compute_dynamic_scales_and_zp,
    generate_gparam,
    maybe_pad_tensor_for_block_quant,
    strategy_cdiv,
)
from compressed_tensors_tpu_torch.ops.fp4 import cast_to_fp4  # noqa: F401
from compressed_tensors_tpu_torch.ops.pack import (  # noqa: F401
    pack_to_int32,
    unpack_from_int32,
)
from compressed_tensors_tpu_torch.ops.fp4_pack import (  # noqa: F401
    pack_fp4_to_uint8,
    unpack_fp4_from_uint8,
)
