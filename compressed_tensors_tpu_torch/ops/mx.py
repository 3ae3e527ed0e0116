"""MX (MXFP4 / MXFP8) E8M0 scale math: scales are biased (127)
power-of-two exponents stored as uint8.

Counterpart of ``compressed_tensors_tpu/ops/mx.py``, bit for bit.
"""

from __future__ import annotations

import math

import torch

from compressed_tensors_tpu_torch.quantization.quant_args import (
    FP4_E2M1_DATA,
    FP8_E4M3_DATA,
    QuantizationArgs,
    QuantizationType,
)

__all__ = [
    "round_to_power_2",
    "generate_mx_scales",
    "should_generate_mx_scales",
    "maybe_convert_from_mx_exp",
    "compress_mx_scale",
    "decompress_mx_scale",
]

# floor(log2(element max)): FP4 max 6 -> 2, FP8 max 448 -> 8
_MX_ELEM_OFFSET = {
    4: int(math.floor(math.log2(FP4_E2M1_DATA.max))),
    8: int(math.floor(math.log2(FP8_E4M3_DATA.max))),
}

# float dtype -> (same-width signed integer dtype, mantissa bits, exponent
# bits)
_FLOAT_LAYOUT = {
    torch.bfloat16: (torch.int16, 7, 8),
    torch.float16: (torch.int16, 10, 5),
    torch.float32: (torch.int32, 23, 8),
    torch.float64: (torch.int64, 52, 11),
}


def should_generate_mx_scales(args: QuantizationArgs) -> bool:
    """MX formats: 4- or 8-bit float, group size 32, uint8 scales."""
    return (args.num_bits in (4, 8)
            and args.type == QuantizationType.FLOAT.value
            and args.group_size == 32
            and args.scale_dtype == torch.uint8)


def round_to_power_2(x: torch.Tensor) -> torch.Tensor:
    """Round to a power of two by masking the exponent bits after adding
    half an FP4 mantissa step (rounds down past it)."""
    if x.dtype not in _FLOAT_LAYOUT:
        raise TypeError(f"Unsupported dtype {x.dtype}")
    int_dtype, mantissa, exponent = _FLOAT_LAYOUT[x.dtype]
    width = 8 * x.dtype.itemsize
    val_to_add = 1 << (mantissa - FP4_E2M1_DATA.mantissa - 1)
    # the sign and exponent bits as a two's-complement mask of this width
    mask = (((1 << (exponent + 1)) - 1) << mantissa) - (1 << width)
    bits = x.view(int_dtype).to(torch.int64)
    # the unsigned sum wraps at the type's width, as in the JAX package
    masked = (bits + val_to_add) & mask
    if width < 64:
        masked = (masked + (1 << (width - 1))) % (1 << width) - (
            1 << (width - 1))
    return masked.to(int_dtype).view(x.dtype)


def generate_mx_scales(x: torch.Tensor, num_bits: int = 4) -> torch.Tensor:
    """Per-group max-abs -> biased E8M0 exponent, in x's dtype (callers
    round it to uint8)."""
    offset = _MX_ELEM_OFFSET[num_bits]
    return 127 + torch.floor(torch.log2(round_to_power_2(x))) - offset


def maybe_convert_from_mx_exp(args: QuantizationArgs,
                              scale: torch.Tensor) -> torch.Tensor:
    """Under MX args, turn E8M0 exponents into power-of-two scales."""
    if should_generate_mx_scales(args):
        exp = (scale.to(torch.int32) - 127).to(torch.float32)
        return torch.exp2(exp).to(scale.dtype)
    return scale


def compress_mx_scale(scale: torch.Tensor,
                      scale_dtype=torch.uint8) -> torch.Tensor:
    """Float power-of-two scale -> E8M0 biased exponent."""
    exp = 127 + torch.floor(torch.log2(scale.to(torch.float32))).to(
        torch.int32)
    return exp.to(scale_dtype)


def decompress_mx_scale(scale: torch.Tensor) -> torch.Tensor:
    """E8M0 biased exponent -> bf16 power-of-two scale."""
    exp = (scale.to(torch.int32) - 127).to(torch.float32)
    return torch.exp2(exp).to(torch.bfloat16)
