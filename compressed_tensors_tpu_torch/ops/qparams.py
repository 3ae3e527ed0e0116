"""Quantization-parameter math: ranges, scale/zero-point calculation,
dynamic (per-call) scales, NVFP4 global scales and the block strategy's
padding.

Counterpart of ``compressed_tensors_tpu/ops/qparams.py``, with the same
numerics (zero always representable, eps flooring of zero scales, the
NVFP4 global-scale product, MX E8M0 scales). Divisions take a tensor
divisor: CUDA divides by a Python scalar as a multiply by its reciprocal,
which is not the IEEE division the JAX package does.
"""

from __future__ import annotations

import math

import torch

from compressed_tensors_tpu_torch.ops.mx import (
    generate_mx_scales,
    maybe_convert_from_mx_exp,
    should_generate_mx_scales,
)
from compressed_tensors_tpu_torch.quantization.quant_args import (
    FP4_E2M1_DATA,
    FP8_E4M3_DATA,
    FloatArgs,
    QuantizationArgs,
    QuantizationStrategy,
    QuantizationType,
    round_to_quantized_type_dtype,
)

__all__ = [
    "calculate_range",
    "calculate_qparams",
    "compute_dynamic_scales_and_zp",
    "generate_gparam",
    "strategy_cdiv",
    "calculate_block_padding",
    "maybe_pad_tensor_for_block_quant",
    "KV_CACHE_TARGETS",
]

# targets for KV-cache scale attachment
KV_CACHE_TARGETS = ["re:.*(self_attn|attention)$"]


def calculate_range(args: QuantizationArgs) -> tuple[float, float]:
    """Effective quantization range endpoints."""
    if args.type == QuantizationType.INT.value:
        bit_range = 2.0**args.num_bits
        return (-bit_range / 2, bit_range / 2 - 1)
    if args.type == QuantizationType.FLOAT.value and args.num_bits == 8:
        return (FP8_E4M3_DATA.min, FP8_E4M3_DATA.max)
    if args.type == QuantizationType.FLOAT.value and args.num_bits == 4:
        return (FP4_E2M1_DATA.min, FP4_E2M1_DATA.max)
    raise NotImplementedError(
        f"range of {args.type} with {args.num_bits} bits")


def _get_dtype_eps(dtype: torch.dtype) -> float:
    """eps floor used to avoid zero scales."""
    if dtype == torch.float8_e4m3fn:
        return 0.125
    if not dtype.is_floating_point:
        return 1.0
    return float(torch.finfo(dtype).eps)


def calculate_qparams(
    min_vals: torch.Tensor,
    max_vals: torch.Tensor,
    quantization_args: QuantizationArgs,
    global_scale: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scales and zero points from observed min/max; zero points are in
    args.zp_dtype. MX args give power-of-two scales; a ``global_scale``
    (NVFP4) multiplies the local scales before they round to
    args.scale_dtype."""
    min_vals = torch.minimum(min_vals, torch.zeros_like(min_vals))
    max_vals = torch.maximum(max_vals, torch.zeros_like(max_vals))

    bit_min, bit_max = calculate_range(quantization_args)
    bit_range = bit_max - bit_min

    if quantization_args.symmetric:
        max_val_pos = torch.maximum(min_vals.abs(), max_vals.abs())
        if should_generate_mx_scales(quantization_args):
            scales = generate_mx_scales(max_val_pos,
                                        num_bits=quantization_args.num_bits)
        else:
            scales = max_val_pos / torch.full_like(max_val_pos,
                                                   float(bit_range) / 2)
        zero_points = torch.zeros_like(scales)
    else:
        if (quantization_args.num_bits == 4
                and quantization_args.type == QuantizationType.FLOAT.value):
            raise NotImplementedError(
                "Asymmetric Quantization is not supported for FP4")
        scales = (max_vals - min_vals) / torch.full_like(max_vals,
                                                         float(bit_range))
        zero_points = (bit_min - min_vals / scales).clamp(bit_min, bit_max)

    if global_scale is not None:
        scales = global_scale * scales
    if quantization_args.scale_dtype is not None:
        scales = round_to_quantized_type_dtype(
            scales, dtype=quantization_args.scale_dtype)
    scales = maybe_convert_from_mx_exp(quantization_args, scales)

    eps = _get_dtype_eps(quantization_args.scale_dtype
                         if quantization_args.scale_dtype is not None
                         else scales.dtype)
    scales = torch.where(scales == 0, torch.full_like(scales, eps), scales)
    zero_points = round_to_quantized_type_dtype(
        zero_points, dtype=quantization_args.zp_dtype,
        cast_to_original_dtype=False)

    if scales.ndim == 0:
        scales = scales.reshape(1)
        zero_points = zero_points.reshape(1)
    return scales, zero_points


def compute_dynamic_scales_and_zp(
    value: torch.Tensor, args: QuantizationArgs,
    global_scale: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic scale/zp: TOKEN reduces every dim except (0, 1) -- so a 2D
    input reduces to one scale, as in the JAX package --, TENSOR reduces
    all, GROUP/TENSOR_GROUP reduce within last-dim groups."""
    keep_dims = True
    if args.strategy == QuantizationStrategy.TOKEN.value:
        reduce_dims = tuple(i for i in range(value.ndim) if i not in (0, 1))
    elif args.strategy == QuantizationStrategy.TENSOR.value:
        reduce_dims = None
    elif args.strategy in (QuantizationStrategy.TENSOR_GROUP.value,
                           QuantizationStrategy.GROUP.value):
        reduce_dims = (-1,)
        keep_dims = False
        num_groups = math.ceil(value.shape[-1] / args.group_size)
        value = value.reshape(*value.shape[:-1], num_groups, args.group_size)
    else:
        raise ValueError(
            "Dynamic quantization is only supported for "
            "token/tensor/group/tensor_group")

    if not reduce_dims:
        min_val, max_val = value.min(), value.max()
    else:
        min_val = value.amin(dim=reduce_dims, keepdim=keep_dims)
        max_val = value.amax(dim=reduce_dims, keepdim=keep_dims)
    return calculate_qparams(min_val, max_val, args,
                             global_scale=global_scale)


def generate_gparam(
    updated_min_val: torch.Tensor,
    updated_max_val: torch.Tensor,
    scale_data: type[FloatArgs] = FP8_E4M3_DATA,
    quant_data: type[FloatArgs] = FP4_E2M1_DATA,
    dtype=torch.float32,
) -> torch.Tensor:
    """NVFP4 global scale = fp8 max * fp4 max / max|x|, NaN and inf -> 1,
    as a (1,) tensor of ``dtype``."""
    min_vals = torch.minimum(updated_min_val, torch.zeros_like(updated_min_val))
    max_vals = torch.maximum(updated_max_val, torch.zeros_like(updated_max_val))
    max_val_pos = torch.maximum(min_vals.abs(), max_vals.abs())
    tiny_dtype = (max_val_pos.dtype if max_val_pos.dtype in (
        torch.float32, torch.float64) else torch.float32)
    max_val_pos = max_val_pos.clamp_min(torch.finfo(tiny_dtype).tiny)
    global_scale = torch.full_like(
        max_val_pos, scale_data.max * quant_data.max) / max_val_pos
    global_scale = torch.nan_to_num(global_scale, nan=1.0, posinf=1.0,
                                    neginf=1.0)
    return global_scale.to(dtype).reshape([1])


def strategy_cdiv(
    value: int,
    divisor: int,
    strategy: QuantizationStrategy | None = None,
    strict: bool = False,
) -> int:
    """ceil(value / divisor); warns (or with ``strict`` raises) when the
    division is not exact."""
    dividend = math.ceil(value / divisor)
    if dividend * divisor != value:
        message = (
            f"{strategy} quantization strategy requires strict division of "
            f"weight/activation size {value} and group/block size {divisor}.")
        if strict:
            raise ValueError(message)
        import logging

        logging.getLogger(__name__).warning(message)
    return dividend


def calculate_block_padding(
    shape: tuple[int, ...], block_structure: tuple[int, int]
) -> tuple[int, int]:
    """Rows and columns of padding that make the last two dims divisible
    by the block."""
    if len(shape) < 2:
        raise ValueError(f"Tensor must be at least 2D, got shape {shape}")
    rows, cols = shape[-2], shape[-1]
    block_height, block_width = block_structure
    return ((block_height - rows % block_height) % block_height,
            (block_width - cols % block_width) % block_width)


def maybe_pad_tensor_for_block_quant(
    tensor: torch.Tensor, block_structure: tuple[int, int]
) -> torch.Tensor:
    """Zero-pad the last two dims to block-divisible sizes."""
    pad_rows, pad_cols = calculate_block_padding(tuple(tensor.shape),
                                                 block_structure)
    if pad_rows == 0 and pad_cols == 0:
        return tensor
    rows, cols = tensor.shape[-2:]
    out = torch.zeros((*tensor.shape[:-2], rows + pad_rows, cols + pad_cols),
                      dtype=tensor.dtype, device=tensor.device)
    out[..., :rows, :cols] = tensor
    return out
