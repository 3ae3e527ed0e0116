"""Quantized linear algebra: the engine-side weight representation and the
matmul dispatch.

Counterpart of ``compressed_tensors_tpu/ops/linear.py`` for the
run-compressed W4A16 and W8A8 (int8 and fp8) paths. Weights stay compressed on the
device and are dequantized inside the hand-written kernels
(``ops/kernels/``). ``use_kernels=False`` selects the JAX package's
non-kernel path (dequantize the weight, one plain matmul), which the
tests and ``chip_smoke.py`` use as the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from compressed_tensors_tpu_torch.config import CompressionFormat
from compressed_tensors_tpu_torch.ops.kernels.w4a16_matmul import w4a16_matmul
from compressed_tensors_tpu_torch.ops.kernels.w8a8_matmul import w8a8_matmul
from compressed_tensors_tpu_torch.ops.pack import (
    pack_to_int32,
    unpack_from_int32,
)
from compressed_tensors_tpu_torch.ops.qparams import (
    compute_dynamic_scales_and_zp,
)
from compressed_tensors_tpu_torch.ops.quantize import dequantize, quantize
from compressed_tensors_tpu_torch.quantization import (
    QuantizationScheme,
    QuantizationStrategy,
)

__all__ = [
    "QuantizedTensor",
    "quantized_matmul",
    "from_compressed_state",
    "materialize_weight",
    "prepare_for_kernels",
]

_W8_STRATEGIES = (QuantizationStrategy.CHANNEL.value,
                  QuantizationStrategy.TENSOR.value)


@dataclasses.dataclass
class QuantizedTensor:
    """A weight in compressed form plus everything a matmul needs.

    The checkpoint-layout fields mirror the JAX package's; the ``kernel_*``
    fields hold this port's kernel layout, built by ``prepare_for_kernels``
    and never serialized.
    """

    weight: Optional[torch.Tensor] = None          # dense / naive repr
    weight_packed: Optional[torch.Tensor] = None   # int32 packed repr
    scale: Optional[torch.Tensor] = None
    zero_point: Optional[torch.Tensor] = None
    g_idx: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None

    # kernel layout: ("w4a16", n, k, group_size): packed (N, K/8) int32,
    # scales / zp (K/g, N) f32; ("w8a8", n, k): weight (N, K) int8/fp8,
    # scales (N,) f32. Kinds the JAX package serves with a kernel this port
    # has not written yet carry only kernel_meta.
    kernel_packed: Optional[torch.Tensor] = None
    kernel_scales: Optional[torch.Tensor] = None
    kernel_zp: Optional[torch.Tensor] = None
    # actorder (g_idx) checkpoints: column permutation applied to the
    # kernel weights at load and to x before the kernel
    kernel_perm: Optional[torch.Tensor] = None
    kernel_meta: Any = None

    format: str = CompressionFormat.dense.value
    shape: tuple = ()
    scheme: Any = None


def from_compressed_state(
    state: dict[str, torch.Tensor],
    scheme: QuantizationScheme | None,
    format: str | CompressionFormat | None = None,
) -> QuantizedTensor:
    """Build a QuantizedTensor from a per-module compressed state dict as
    loaded from a checkpoint."""
    fmt = format or (scheme.format if scheme is not None else None)
    fmt = CompressionFormat(fmt).value if fmt is not None else None
    weight = state.get("weight")
    weight_packed = state.get("weight_packed")
    if fmt is None:
        if weight_packed is not None:
            fmt = CompressionFormat.pack_quantized.value
        elif weight is not None and (not weight.dtype.is_floating_point
                                     or weight.dtype.itemsize == 1):
            fmt = CompressionFormat.naive_quantized.value
        else:
            fmt = CompressionFormat.dense.value

    if "weight_shape" in state:
        shape = tuple(int(v) for v in state["weight_shape"])
    elif weight is not None:
        shape = tuple(weight.shape)
    elif weight_packed is not None:
        shape = tuple(weight_packed.shape)
    else:
        shape = ()
    return QuantizedTensor(
        weight=weight,
        weight_packed=weight_packed,
        scale=state.get("weight_scale"),
        zero_point=state.get("weight_zero_point"),
        g_idx=state.get("weight_g_idx"),
        bias=state.get("bias"),
        format=fmt,
        shape=shape,
        scheme=scheme,
    )


def _unpacked_zero_point(qt: QuantizedTensor, num_bits: int):
    zp = qt.zero_point
    if zp is not None and zp.dtype == torch.int32:  # packed along dim 0
        zp = unpack_from_int32(zp, num_bits, (qt.shape[0], qt.scale.shape[-1]),
                               packed_dim=0)
    return zp


def materialize_weight(qt: QuantizedTensor, dtype=torch.bfloat16
                       ) -> torch.Tensor:
    """Dequantize the compressed representation to a dense (N, K) weight
    (the non-kernel path)."""
    fmt = qt.format
    args = qt.scheme.weights if qt.scheme is not None else None
    if fmt == CompressionFormat.dense.value or (
            qt.weight is not None and qt.weight.dtype.is_floating_point
            and qt.weight.dtype.itemsize > 1):
        return qt.weight.to(dtype)
    if fmt == CompressionFormat.pack_quantized.value:
        unpacked = unpack_from_int32(qt.weight_packed, args.num_bits, qt.shape)
        return dequantize(unpacked, qt.scale,
                          _unpacked_zero_point(qt, args.num_bits), args,
                          g_idx=qt.g_idx, dtype=dtype)
    if fmt in (CompressionFormat.naive_quantized.value,
               CompressionFormat.int_quantized.value,
               CompressionFormat.float_quantized.value):
        return dequantize(qt.weight, qt.scale, qt.zero_point, args,
                          g_idx=qt.g_idx, dtype=dtype)
    raise NotImplementedError(f"materialize_weight for format {fmt}")


def prepare_for_kernels(qt: QuantizedTensor) -> QuantizedTensor:
    """Build this port's kernel layout beside the checkpoint layout.

    - W8A8 (int8 or fp8 weights, channel/tensor scales, dynamic symmetric
      acts): the checkpoint's (N, K) weight and an (N,) f32 scale. Under
      ``fp8_transcode`` fp8 weights are re-gridded to int8 here, as the
      JAX package does: per output channel w * 127 / absmax, rounded, with
      the scale times absmax / 127.
    - W4A16 pack-quantized group: the checkpoint's (N, K/8) int32 words
      (column-permuted for actorder checkpoints) and (K/g, N) f32 scales /
      zero points.
    - Other WnA16 group widths and FP4 formats, which the JAX package
      serves with kernels not ported yet (ROADMAP B9, B8), get only a
      ``kernel_meta`` marker.
    Everything else keeps the checkpoint representation.
    """
    args = qt.scheme.weights if qt.scheme is not None else None
    acts = qt.scheme.input_activations if qt.scheme is not None else None

    if (qt.weight is not None
            and qt.weight.dtype in (torch.int8, torch.float8_e4m3fn)
            and args is not None and args.strategy in _W8_STRATEGIES
            and acts is not None and acts.dynamic is True and acts.symmetric
            and len(qt.shape) == 2):
        n, k = qt.shape
        w_scale = qt.scale.to(torch.float32).reshape(-1)
        if w_scale.numel() == 1 and n > 1:  # per-tensor -> per-channel
            w_scale = w_scale.expand(n)
        weight = qt.weight
        if weight.dtype == torch.float8_e4m3fn and _transcode_fp8_enabled():
            wf = weight.to(torch.float32)
            absmax = wf.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
            # tensor divisors: CUDA divides by a Python scalar as a
            # multiply by its reciprocal, not an IEEE division
            weight = torch.round(
                wf * (torch.full_like(absmax, 127.0) / absmax)).to(torch.int8)
            w_scale = w_scale * (absmax / torch.full_like(absmax, 127.0)
                                 ).reshape(-1)
        return dataclasses.replace(
            qt, kernel_packed=weight.contiguous(),
            kernel_scales=w_scale.contiguous(), kernel_meta=("w8a8", n, k))

    if qt.format in (CompressionFormat.nvfp4_pack_quantized.value,
                     CompressionFormat.mxfp4_pack_quantized.value):
        return dataclasses.replace(qt, kernel_meta=("fp4",))

    if (qt.format != CompressionFormat.pack_quantized.value or args is None
            or args.num_bits not in range(2, 9)
            or args.strategy != QuantizationStrategy.GROUP.value
            or len(qt.shape) != 2 or qt.shape[1] % args.group_size != 0):
        return qt
    n, k = qt.shape
    if args.num_bits != 4:
        if qt.zero_point is not None and args.num_bits >= 8:
            return qt  # the JAX package has no kernel for 8-bit asym either
        return dataclasses.replace(qt, kernel_meta=("w4e8",))

    packed = qt.weight_packed
    kernel_perm = None
    if qt.g_idx is not None:
        # actorder: permute columns so quant groups are contiguous; the
        # matmul gathers x by the same permutation
        order = torch.argsort(qt.g_idx.to(torch.int64), stable=True)
        packed = pack_to_int32(
            unpack_from_int32(packed, 4, qt.shape).index_select(1, order), 4)
        kernel_perm = order
    zp = _unpacked_zero_point(qt, 4)
    return dataclasses.replace(
        qt,
        kernel_packed=packed.contiguous(),
        kernel_scales=qt.scale.to(torch.float32).t().contiguous(),
        kernel_zp=(zp.to(torch.float32).t().contiguous()
                   if zp is not None else None),
        kernel_perm=kernel_perm,
        kernel_meta=("w4a16", n, k, args.group_size),
    )


def _transcode_fp8_enabled() -> bool:
    """Whether fp8 weights and KV caches are re-gridded to int8 (see
    flags.fp8_transcode): "always" yes, "never" and "auto" no."""
    from compressed_tensors_tpu_torch.flags import FLAGS

    if FLAGS.fp8_transcode not in ("auto", "always", "never"):
        raise ValueError(f"fp8_transcode={FLAGS.fp8_transcode!r}")
    return FLAGS.fp8_transcode == "always"


def _w4b8_mode(m_rows: int, n: int, k: int) -> str:
    """Activation precision of the W4A16 kernel (see flags.w4_act)."""
    from compressed_tensors_tpu_torch.flags import FLAGS

    if FLAGS.w4_act == "int8":
        return "a8b"
    if FLAGS.w4_act == "bf16":
        return "int4b"
    return "a8b" if m_rows >= 256 and n >= 4096 and k >= 4096 else "int4b"


def _dense_matmul(x, w):
    return torch.matmul(x.to(torch.float32), w.to(torch.float32).t()).to(
        x.dtype)


def _int8_dynamic_matmul(x, qt: QuantizedTensor, input_args):
    """W8A8-int non-kernel path: dynamic per-token quant, an exact integer
    product (summed in f64), per-token x per-channel rescale."""
    x_scale, _ = compute_dynamic_scales_and_zp(x, input_args)
    x_q = quantize(x, x_scale, None, input_args, dtype=torch.int8)
    acc = torch.matmul(x_q.to(torch.float64), qt.weight.to(torch.float64).t())
    w_scale = qt.scale.reshape(-1).to(torch.float32)
    out = acc.to(torch.float32) * x_scale.to(torch.float32) * w_scale
    return out.to(x.dtype)


def _fp8_matmul(x, qt: QuantizedTensor, input_args):
    """FP8 W8A8 non-kernel path: acts quantized to fp8 (dynamic scale) or
    weight-only dequantize."""
    w_scale = qt.scale.to(torch.float32)
    if input_args is not None and input_args.dynamic is True:
        x_scale, _ = compute_dynamic_scales_and_zp(x, input_args)
        x_q = quantize(x, x_scale, None, input_args, dtype=qt.weight.dtype)
        acc = torch.matmul(x_q.to(torch.float32),
                           qt.weight.to(torch.float32).t())
        return (acc * x_scale.to(torch.float32) * w_scale.reshape(-1)).to(
            x.dtype)
    w = dequantize(qt.weight, qt.scale, None, qt.scheme.weights, dtype=x.dtype)
    return _dense_matmul(x, w)


def quantized_matmul(x: torch.Tensor, qt: QuantizedTensor,
                     use_kernels: bool = True) -> torch.Tensor:
    """y = x @ W^T (+ bias) with W in compressed form.

    With ``use_kernels`` and a kernel layout, the W4A16 and W8A8 kernels
    run (their plain versions for CPU tensors); otherwise the non-kernel
    path of the JAX package: W8A8-int / fp8 dynamic products, or dequantize
    then one plain matmul.
    """
    scheme = qt.scheme
    input_args = scheme.input_activations if scheme is not None else None
    weights_args = scheme.weights if scheme is not None else None
    w8 = (qt.weight is not None and input_args is not None
          and input_args.num_bits == 8 and weights_args is not None
          and weights_args.strategy in _W8_STRATEGIES)
    use_int8_path = (w8 and qt.weight.dtype == torch.int8
                     and input_args.dynamic is True
                     and input_args.type == "int")
    use_fp8_path = (w8 and qt.weight.dtype == torch.float8_e4m3fn
                    and input_args.type == "float")

    kind = qt.kernel_meta[0] if qt.kernel_meta is not None else None
    if use_kernels and kind in ("fp4", "w4e8") and x.is_cuda:
        item = "B8 (fp4 matmul)" if kind == "fp4" else "B9 (w4_e8_matmul)"
        raise NotImplementedError(
            f"{qt.format} {weights_args.num_bits}-bit weights have no CUDA "
            f"kernel yet (ROADMAP {item})")
    lead = x.shape[:-1]
    if use_kernels and kind in ("w4a16", "w8a8"):
        if qt.kernel_perm is not None:
            x = x.index_select(-1, qt.kernel_perm)
        k = qt.kernel_meta[2]
        x2 = x.reshape(-1, k).contiguous()
        if kind == "w8a8":
            n = qt.kernel_meta[1]
            out = w8a8_matmul(x2, qt.kernel_packed, qt.kernel_scales, n=n, k=k)
        else:
            _, n, _, group_size = qt.kernel_meta
            out = w4a16_matmul(x2, qt.kernel_packed,
                               qt.kernel_scales, qt.kernel_zp, n=n, k=k,
                               group_size=group_size,
                               mode=_w4b8_mode(x2.shape[0], n, k))
        out = out.reshape(*lead, n)
    elif use_int8_path:
        out = _int8_dynamic_matmul(x, qt, input_args)
    elif use_fp8_path:
        out = _fp8_matmul(x, qt, input_args)
    else:
        out = _dense_matmul(x, materialize_weight(qt, dtype=x.dtype))
    if qt.bias is not None:
        out = out + qt.bias.to(out.dtype)
    return out
