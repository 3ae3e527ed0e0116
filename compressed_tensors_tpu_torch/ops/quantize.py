"""Quantize / dequantize / fake-quantize: the QDQ math.

Counterpart of ``compressed_tensors_tpu/ops/quantize.py`` for every
strategy (tensor, channel, token, attn_head, group, tensor-group and
block) of int, fp8 and fp4 quantization, with NVFP4's global scale. Same
operation order and result dtypes as the JAX package, so f32 results
agree to the last bit on the CPU. The global scale divides the local scales in f32,
as JAX's promotion of a bf16 scale against the f32 global scale does
(PyTorch would keep bf16 against a 0-dim tensor).
"""

from __future__ import annotations

import math

import torch

from compressed_tensors_tpu_torch.ops.fp4 import cast_to_fp4
from compressed_tensors_tpu_torch.ops.qparams import (
    calculate_range,
    maybe_pad_tensor_for_block_quant,
)
from compressed_tensors_tpu_torch.quantization.quant_args import (
    QuantizationArgs,
    QuantizationStrategy,
    QuantizationType,
)

__all__ = ["quantize", "dequantize", "fake_quantize",
           "infer_args_from_scale_shape"]


def _round_to_grid(x, args: QuantizationArgs, q_min, q_max):
    x = x.clamp(q_min, q_max)
    if args.type == QuantizationType.FLOAT.value and args.num_bits == 8:
        return x.to(torch.float8_e4m3fn).to(x.dtype)
    if args.type == QuantizationType.FLOAT.value and args.num_bits == 4:
        return cast_to_fp4(x)
    if args.type == QuantizationType.INT.value:
        return torch.round(x)
    raise NotImplementedError(f"{args.type} with {args.num_bits} bits")


def _over_global(scale, global_scale):
    """scale / global_scale in f32 (the NVFP4 local scale)."""
    if global_scale is None:
        return scale
    return scale.to(torch.float32) / global_scale.to(torch.float32)


def _quantize_op(x, scale, zero_point, q_min, q_max, args, dtype,
                 global_scale):
    scale = _over_global(scale, global_scale)
    scaled = x / scale.to(x.dtype)
    if zero_point is not None:
        scaled = scaled + zero_point.to(x.dtype)
    q = _round_to_grid(scaled, args, q_min, q_max)
    return q.to(dtype) if dtype is not None else q


def _dequantize_op(x_q, scale, zero_point, dtype, global_scale):
    scale = _over_global(scale, global_scale)
    # narrow float scales compute in f32 (no fp8 arithmetic)
    compute = torch.float32 if scale.dtype.itemsize == 1 else scale.dtype
    dq = x_q.to(compute)
    if zero_point is not None:
        dq = dq - zero_point.to(compute)
    dq = dq * scale.to(compute)
    return dq.to(dtype) if dtype is not None else dq


def _qdq_op(x, scale, zero_point, q_min, q_max, args, global_scale):
    """Quantize then dequantize with one scale division; the result is in
    the (global-divided) scale's dtype, as in the JAX package."""
    scale = _over_global(scale, global_scale)
    scaled = x / scale.to(x.dtype)
    if zero_point is not None:
        scaled = scaled + zero_point.to(x.dtype)
    dq = _round_to_grid(scaled, args, q_min, q_max).to(scale.dtype)
    if zero_point is not None:
        dq = dq - zero_point.to(scale.dtype)
    return dq * scale


def _apply(x, scale, zero_point, q_min, q_max, args, dtype, do_quantize,
           global_scale, do_dequantize=False):
    if do_quantize and do_dequantize:
        return _qdq_op(x, scale, zero_point, q_min, q_max, args, global_scale)
    if do_quantize:
        return _quantize_op(x, scale, zero_point, q_min, q_max, args, dtype,
                            global_scale)
    return _dequantize_op(x, scale, zero_point, dtype, global_scale)


def _process_block(x, scale, zero_point, args, q_min, q_max, dtype,
                   do_quantize, global_scale, do_dequantize):
    """Block strategy: zero-pad to whole blocks, view as (Rb, Cb, bh, bw),
    apply each block's scale, restore (and crop the padding)."""
    original_shape = tuple(x.shape)
    block_height, block_width = args.block_structure
    x = maybe_pad_tensor_for_block_quant(x, args.block_structure)
    padded_shape = tuple(x.shape)
    rows_b = padded_shape[0] // block_height
    cols_b = padded_shape[1] // block_width
    blocks = x.reshape(rows_b, block_height, cols_b, block_width).permute(
        0, 2, 1, 3)
    out = _apply(blocks, scale[..., None, None],
                 zero_point[..., None, None] if zero_point is not None
                 else None, q_min, q_max, args, dtype, do_quantize,
                 global_scale, do_dequantize)
    out = out.permute(0, 2, 1, 3).reshape(padded_shape)
    if original_shape != padded_shape:
        out = out[:original_shape[0], :original_shape[1]]
    return out


def _process_group(x, scale, zero_point, args, q_min, q_max, dtype,
                   do_quantize, g_idx, global_scale, do_dequantize):
    """Group and tensor-group strategies: optional activation-order
    permutation, reshape the last dim into (groups, group_size), apply,
    restore."""
    group_size = args.group_size
    output_dtype = dtype if dtype is not None else x.dtype
    columns = x.shape[-1]
    while scale.ndim < 2:
        scale = scale[..., None]
        zero_point = zero_point[..., None] if zero_point is not None else None
    if columns >= group_size and columns % group_size != 0:
        raise ValueError(
            "tensor column shape must be divisible "
            f"by the given group_size {group_size} but got {columns}")

    perm = None
    if g_idx is not None:
        perm = torch.argsort(g_idx, stable=True)
        x = x.index_select(-1, perm)

    num_groups = math.ceil(x.shape[-1] / group_size)
    x = x.reshape(*x.shape[:-1], num_groups, group_size)
    out = _apply(x, scale[..., None],
                 zero_point[..., None] if zero_point is not None else None,
                 q_min, q_max, args, dtype, do_quantize, global_scale,
                 do_dequantize)
    out = out.reshape(*out.shape[:-2], num_groups * group_size).to(
        output_dtype)
    if perm is not None:
        out = out.index_select(-1, torch.argsort(perm))
    return out


def _process(x, scale, zero_point, args, g_idx, dtype, do_quantize,
             global_scale, do_dequantize=False):
    q_min, q_max = calculate_range(args)
    if args.strategy == QuantizationStrategy.BLOCK.value:
        return _process_block(x, scale, zero_point, args, q_min, q_max,
                              dtype, do_quantize, global_scale, do_dequantize)
    if args.strategy in (QuantizationStrategy.GROUP.value,
                         QuantizationStrategy.TENSOR_GROUP.value):
        return _process_group(x, scale, zero_point, args, q_min, q_max,
                              dtype, do_quantize, g_idx, global_scale,
                              do_dequantize)
    # tensor, channel, token, attn_head: plain broadcasting
    return _apply(x, scale, zero_point, q_min, q_max, args, dtype,
                  do_quantize, global_scale, do_dequantize)


def quantize(x, scale, zero_point, args: QuantizationArgs, dtype=None,
             g_idx=None, global_scale=None) -> torch.Tensor:
    """Quantize x per the strategy in args."""
    return _process(x, scale, zero_point, args, g_idx, dtype, True,
                    global_scale)


def infer_args_from_scale_shape(x_q_shape, scale_shape) -> QuantizationArgs:
    """The strategy a scale's shape implies: 0/1-D tensor, (rows, 1)
    channel, (1 or rows, groups) group, any other 2-D shape block."""
    ndim = len(scale_shape)
    if ndim in (0, 1):
        return QuantizationArgs(strategy=QuantizationStrategy.TENSOR)
    if ndim == 2:
        if scale_shape[1] == 1:
            return QuantizationArgs(strategy=QuantizationStrategy.CHANNEL)
        if scale_shape[0] == 1 or scale_shape[0] == x_q_shape[0]:
            return QuantizationArgs(
                strategy=QuantizationStrategy.GROUP,
                group_size=int(x_q_shape[1] / scale_shape[1]))
        rows, cols = x_q_shape[-2], x_q_shape[-1]
        return QuantizationArgs(
            strategy=QuantizationStrategy.BLOCK,
            block_structure=[rows // scale_shape[0], cols // scale_shape[1]])
    raise ValueError(
        f"Could not infer a quantization strategy from scale with {ndim} "
        "dimensions. Expected 0 or 2 dimensions.")


def dequantize(x_q, scale, zero_point=None, args: QuantizationArgs = None,
               dtype=None, g_idx=None, global_scale=None) -> torch.Tensor:
    """Dequantize x_q; without args the strategy follows from the scale's
    shape (``infer_args_from_scale_shape``)."""
    if args is None:
        args = infer_args_from_scale_shape(tuple(x_q.shape),
                                           tuple(scale.shape))
    if dtype is None:
        dtype = scale.dtype
        if dtype.itemsize == 1 or not dtype.is_floating_point:
            dtype = torch.float32
    return _process(x_q, scale, zero_point, args, g_idx, dtype, False,
                    global_scale)


def fake_quantize(x, scale, zero_point, args: QuantizationArgs, g_idx=None,
                  global_scale=None) -> torch.Tensor:
    """Quantize then dequantize x per the strategy in args."""
    return _process(x, scale, zero_point, args, g_idx, None, True,
                    global_scale, do_dequantize=True)
