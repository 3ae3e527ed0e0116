"""Quantization-parameter math used on the run-compressed path: ranges,
scale/zero-point calculation and dynamic (per-call) scales.

Counterpart of ``compressed_tensors_tpu/ops/qparams.py``, with the same
numerics (zero always representable, eps flooring of zero scales). The MX
and global-scale branches wait for the FP4/MX slice.
"""

from __future__ import annotations

import math

import torch

from compressed_tensors_tpu_torch.quantization.quant_args import (
    FP8_E4M3_DATA,
    QuantizationArgs,
    QuantizationStrategy,
    QuantizationType,
    round_to_quantized_type_dtype,
)

__all__ = [
    "calculate_range",
    "calculate_qparams",
    "compute_dynamic_scales_and_zp",
]


def calculate_range(args: QuantizationArgs) -> tuple[float, float]:
    """Effective quantization range endpoints."""
    if args.type == QuantizationType.INT.value:
        bit_range = 2.0**args.num_bits
        return (-bit_range / 2, bit_range / 2 - 1)
    if args.type == QuantizationType.FLOAT.value and args.num_bits == 8:
        return (FP8_E4M3_DATA.min, FP8_E4M3_DATA.max)
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scales and zero points from observed min/max; zero points are in
    args.zp_dtype."""
    min_vals = torch.minimum(min_vals, torch.zeros_like(min_vals))
    max_vals = torch.maximum(max_vals, torch.zeros_like(max_vals))

    bit_min, bit_max = calculate_range(quantization_args)
    bit_range = bit_max - bit_min

    if quantization_args.symmetric:
        max_val_pos = torch.maximum(min_vals.abs(), max_vals.abs())
        scales = max_val_pos / (float(bit_range) / 2)
        zero_points = torch.zeros_like(scales)
    else:
        scales = (max_vals - min_vals) / float(bit_range)
        zero_points = (bit_min - min_vals / scales).clamp(bit_min, bit_max)

    if quantization_args.scale_dtype is not None:
        scales = round_to_quantized_type_dtype(
            scales, dtype=quantization_args.scale_dtype)

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
    value: torch.Tensor, args: QuantizationArgs
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
    return calculate_qparams(min_val, max_val, args)
