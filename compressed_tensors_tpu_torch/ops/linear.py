"""Quantized linear algebra: the engine-side weight representation and the
matmul dispatch.

Counterpart of ``compressed_tensors_tpu/ops/linear.py`` for the
run-compressed WnA16 (int 2-8 bit groups), NVFP4 / MXFP4, MXFP8 and W8A8
(int8 and fp8) paths, 2:4 sparse-24-bitmask stacked over any of the
quantized formats that leave a ``weight``, and the MoE layer's stacked
experts (``stack_quantized_tensors``, ``prepare_experts_for_kernels``,
``quantized_matmul_experts``). Weights stay compressed on the device and
are dequantized inside the hand-written kernels (``ops/kernels/``).
``use_kernels=False`` selects the JAX package's non-kernel path
(dequantize the weight, one plain matmul), which the tests and
``chip_smoke.py`` use as the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from compressed_tensors_tpu_torch.config import CompressionFormat
from compressed_tensors_tpu_torch.flags import kernels_enabled
from compressed_tensors_tpu_torch.ops.bitmask import sparse24_decompress
from compressed_tensors_tpu_torch.ops.fp4_pack import unpack_fp4_from_uint8
from compressed_tensors_tpu_torch.ops.kernels.w4a16_matmul import (
    PLANE_MODES,
    choose_k_tile,
    padded_k,
    repack_w4_for_kernel,
    retile_groups,
    w4_e8_experts_matmul,
    w4_e8_matmul,
    w4a16_experts_matmul,
    w4a16_fp4_matmul,
    w4a16_matmul,
    w4a16_planes_matmul,
)
from compressed_tensors_tpu_torch.ops.kernels.w8a8_matmul import w8a8_matmul
from compressed_tensors_tpu_torch.ops.mx import decompress_mx_scale
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
    "quantized_matmul_experts",
    "from_compressed_state",
    "materialize_weight",
    "prepare_for_kernels",
    "prepare_experts_for_kernels",
    "stack_quantized_tensors",
    "expert_slice",
    "permute_output_rows",
]

_W8_STRATEGIES = (QuantizationStrategy.CHANNEL.value,
                  QuantizationStrategy.TENSOR.value)
_FP4_FORMATS = (CompressionFormat.nvfp4_pack_quantized.value,
                CompressionFormat.mxfp4_pack_quantized.value)


@dataclasses.dataclass
class QuantizedTensor:
    """A weight in compressed form plus everything a matmul needs.

    The checkpoint-layout fields mirror the JAX package's; the ``kernel_*``
    fields hold this port's kernel layout, built by ``prepare_for_kernels``
    and never serialized.
    """

    weight: Optional[torch.Tensor] = None          # dense / naive repr
    weight_packed: Optional[torch.Tensor] = None   # int32 / uint8 packed
    scale: Optional[torch.Tensor] = None
    zero_point: Optional[torch.Tensor] = None
    g_idx: Optional[torch.Tensor] = None
    global_scale: Optional[torch.Tensor] = None    # NVFP4, f32 (1,)
    input_global_scale: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    # 2:4 sparse-24-bitmask: (N, K/2) kept values and (N, K/8) uint8 mask
    sparse_values: Optional[torch.Tensor] = None
    sparse_bitmask: Optional[torch.Tensor] = None

    # kernel layout, by kind (kernel_meta[0]):
    # ("w4a16", n, k, group_size): packed (N, K/8) int32, scales / zp
    #   (K/g, N) f32;
    # ("w4e8", n, k, group_size): (N, K) int8 q - zp, scales (K/g, N) f32;
    # ("fp4", n, k, group_size): the checkpoint's (N, K/2) uint8 E2M1
    #   codes, scales (K/g, N) f32 (NVFP4: e4m3 / global; MXFP4: 2^e);
    # ("w8a8", n, k): weight (N, K) int8/fp8, scales (N,) f32;
    # ("w4packed", n, k, group_size): the JAX package's int32 8-plane
    #   layout, (K_pad/8, N) int32 words and (K_pad/g, N) f32 scales / zp,
    #   K_pad a multiple of 8 groups (padded groups: code 8, scale 0).
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
    loaded from a checkpoint. A 2:4 sparse state keeps its values and
    bitmask as sparse leaves, its shape from ``weight.shape``.

    Unstructured sparse-bitmask states (1-D values) raise
    NotImplementedError: run compressed, the JAX package scatters every
    sparse leaf as 2:4 and fails on them;
    ``ModelCompressor.decompress_state`` decompresses them."""
    fmt = format or (scheme.format if scheme is not None else None)
    fmt = CompressionFormat(fmt).value if fmt is not None else None
    sparse_values = state.get("weight.compressed")
    if sparse_values is not None and (sparse_values.dim() != 2
                                      or "weight.row_offsets" in state):
        raise NotImplementedError(
            "unstructured sparse-bitmask weights do not run compressed; "
            "decompress them with ModelCompressor.decompress_state")
    weight = state.get("weight")
    weight_packed = state.get("weight_packed")
    if fmt is None:
        if weight_packed is not None:
            fmt = (CompressionFormat.pack_quantized.value
                   if weight_packed.dtype == torch.int32
                   else CompressionFormat.nvfp4_pack_quantized.value)
        elif weight is not None and (not weight.dtype.is_floating_point
                                     or weight.dtype.itemsize == 1):
            fmt = CompressionFormat.naive_quantized.value
        else:
            fmt = CompressionFormat.dense.value

    if "weight_shape" in state:
        shape = tuple(int(v) for v in state["weight_shape"])
    elif "weight.shape" in state:
        shape = tuple(int(v) for v in state["weight.shape"])
    elif weight is not None:
        shape = tuple(weight.shape)
    elif weight_packed is not None and fmt in _FP4_FORMATS:
        shape = (*weight_packed.shape[:-1], weight_packed.shape[-1] * 2)
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
        global_scale=state.get("weight_global_scale"),
        input_global_scale=state.get("input_global_scale"),
        bias=state.get("bias"),
        sparse_values=sparse_values,
        sparse_bitmask=state.get("weight.bitmask"),
        format=fmt,
        shape=shape,
        scheme=scheme,
    )


def _unpacked_zero_point(qt: QuantizedTensor, num_bits: int):
    zp = qt.zero_point
    if zp is not None and zp.dtype == torch.int32:  # packed along dim -2
        zp = unpack_from_int32(zp, num_bits,
                               (*qt.shape[:-1], qt.scale.shape[-1]),
                               packed_dim=0)
    return zp


def permute_output_rows(qt: QuantizedTensor, perm) -> QuantizedTensor:
    """Reorder the output features of a compressed weight: row i of the
    result is row perm[i] of the input, for every per-output-row leaf.

    The loader converts DeepSeek's interleaved rope rows to the half
    layout with it, and the checkpoint writer back. Packing runs along
    the input dim, so the weight, packed words and bias permute by row;
    per-row scales and zero points follow (int32 zero points packed along
    the output dim are unpacked, permuted and repacked); g_idx indexes
    input columns and stays. Sparse leaves raise NotImplementedError and
    a prepared tensor (kernel layout built) raises ValueError, as in the
    JAX package.
    """
    perm = torch.as_tensor(perm, dtype=torch.int64)
    n_out = qt.shape[0] if qt.shape else None
    if n_out is None or perm.numel() != n_out:
        raise ValueError(f"perm length {perm.numel()} != out_features {n_out}")
    if qt.sparse_values is not None:
        raise NotImplementedError(
            "output-row permutation of bitmask-sparse weights")
    if qt.kernel_packed is not None:
        raise ValueError("permute before prepare_for_kernels")

    rep = {}
    for field in ("weight", "weight_packed", "bias"):
        leaf = getattr(qt, field)
        if leaf is not None:
            rep[field] = leaf[perm.to(leaf.device)]
    scale = qt.scale
    if scale is not None and scale.dim() >= 1 and scale.shape[0] == n_out:
        rep["scale"] = scale[perm.to(scale.device)]
    zp = qt.zero_point
    if zp is not None:
        idx = perm.to(zp.device)
        if zp.dtype == torch.int32:
            num_bits = qt.scheme.weights.num_bits
            unpacked = unpack_from_int32(zp, num_bits, (n_out, zp.shape[-1]),
                                         packed_dim=0)
            rep["zero_point"] = pack_to_int32(unpacked[idx], num_bits,
                                              packed_dim=0)
        elif zp.dim() >= 1 and zp.shape[0] == n_out:
            rep["zero_point"] = zp[idx]
    return dataclasses.replace(qt, **rep)


def materialize_weight(qt: QuantizedTensor, dtype=torch.bfloat16
                       ) -> torch.Tensor:
    """Dequantize the compressed representation to a dense (N, K) weight
    (the non-kernel path). A 2:4 sparse weight is scattered dense first,
    then dequantized (int and fp8 values) or cast."""
    fmt = qt.format
    args = qt.scheme.weights if qt.scheme is not None else None
    if qt.sparse_values is not None:
        dense_q = sparse24_decompress(qt.sparse_values, qt.sparse_bitmask,
                                      qt.shape)
        if args is not None and (not dense_q.dtype.is_floating_point
                                 or dense_q.dtype.itemsize == 1):
            return dequantize(dense_q, qt.scale, qt.zero_point, args,
                              g_idx=qt.g_idx, dtype=dtype)
        return dense_q.to(dtype)
    if fmt == CompressionFormat.dense.value or (
            qt.weight is not None and qt.weight.dtype.is_floating_point
            and qt.weight.dtype.itemsize > 1):
        return qt.weight.to(dtype)
    if fmt == CompressionFormat.pack_quantized.value:
        unpacked = unpack_from_int32(qt.weight_packed, args.num_bits, qt.shape)
        return dequantize(unpacked, qt.scale,
                          _unpacked_zero_point(qt, args.num_bits), args,
                          g_idx=qt.g_idx, dtype=dtype)
    if fmt in _FP4_FORMATS:
        m, half = qt.weight_packed.shape
        values = unpack_fp4_from_uint8(qt.weight_packed, m, half * 2,
                                       dtype=dtype)
        scale = qt.scale
        if scale.dtype == torch.uint8:  # MX E8M0
            scale = decompress_mx_scale(scale)
        return dequantize(values, scale.to(dtype), None, args,
                          global_scale=qt.global_scale, dtype=dtype)
    if fmt in (CompressionFormat.naive_quantized.value,
               CompressionFormat.int_quantized.value,
               CompressionFormat.float_quantized.value,
               CompressionFormat.mxfp8_quantized.value):
        scale = qt.scale
        if scale is not None and scale.dtype == torch.uint8:  # MXFP8 E8M0
            scale = decompress_mx_scale(scale).to(dtype)
        return dequantize(qt.weight, scale, qt.zero_point, args,
                          g_idx=qt.g_idx, dtype=dtype)
    raise NotImplementedError(f"materialize_weight for format {fmt}")


def prepare_for_kernels(qt: QuantizedTensor,
                        w4_layout: str | None = None) -> QuantizedTensor:
    """Build this port's kernel layout beside the checkpoint layout.

    ``w4_layout`` picks the 4-bit layout; the ``w4_layout`` flag by default.

    - W8A8 (int8 or fp8 weights, channel/tensor scales, dynamic symmetric
      acts): the checkpoint's (N, K) weight and an (N,) f32 scale. Under
      ``fp8_transcode`` fp8 weights are re-gridded to int8 here, as the
      JAX package does: per output channel w * 127 / absmax, rounded, with
      the scale times absmax / 127.
    - NVFP4 / MXFP4: the checkpoint's (N, K/2) E2M1 codes and (K/g, N)
      f32 scales with the global scale divided in (``_prepare_fp4``).
    - W4A16 pack-quantized group, ``w4_layout`` "auto"/"b8": the
      checkpoint's (N, K/8) int32 words and (K/g, N) f32 scales / zero
      points.
    - Other WnA16 widths (2-8 bit), and symmetric W4A16 under
      ``w4_layout="e8"``: (N, K) signed int8 q - zp (zero points folded
      in; 8-bit asymmetric stays on the non-kernel path) and (K/g, N) f32
      scales.
    - W4A16 under ``w4_layout="packed"`` (or asymmetric under "e8"): the
      JAX package's int32 8-plane layout (``_prepare_packed``), run in the
      mode ``w4_mode`` names.
    - 2:4 sparse over a symmetric int scheme: the codes scattered dense
      (a kept zero or a dropped position is code 0, which dequantizes to
      exactly 0), then 4-bit as pack-quantized (the layouts above) and
      8-bit as int8 int-quantized (W8A8); the sparse leaves are dropped
      once a kernel layout exists. Asymmetric schemes and layers no
      kernel takes keep their sparse leaves (the non-kernel path).
    Group layouts of actorder checkpoints are column-permuted, and x is
    gathered by the same permutation at the matmul. Stacked MoE experts
    (E, N, K) take ``prepare_experts_for_kernels``. Everything else keeps
    the checkpoint representation.
    """
    if len(qt.shape) == 3:
        return prepare_experts_for_kernels(qt, w4_layout)
    args = qt.scheme.weights if qt.scheme is not None else None
    acts = qt.scheme.input_activations if qt.scheme is not None else None

    if (qt.sparse_values is not None and args is not None
            and args.type == "int" and args.symmetric
            and len(qt.shape) == 2):
        dense_q = sparse24_decompress(qt.sparse_values, qt.sparse_bitmask,
                                      qt.shape).to(torch.int8)
        if args.num_bits == 4:
            dense = dataclasses.replace(
                qt, sparse_values=None, sparse_bitmask=None, weight=None,
                weight_packed=pack_to_int32(dense_q, 4),
                format=CompressionFormat.pack_quantized.value)
        else:
            dense = dataclasses.replace(
                qt, sparse_values=None, sparse_bitmask=None, weight=dense_q,
                weight_packed=None,
                format=CompressionFormat.int_quantized.value)
        prepped = prepare_for_kernels(dense, w4_layout)
        return prepped if prepped.kernel_meta is not None else qt

    if (qt.weight is not None and qt.sparse_values is None
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

    if (qt.format in _FP4_FORMATS and args is not None
            and args.num_bits == 4
            and args.strategy in (QuantizationStrategy.GROUP.value,
                                  QuantizationStrategy.TENSOR_GROUP.value)
            and len(qt.shape) == 2 and qt.weight_packed is not None
            and qt.shape[1] % (args.group_size or 1) == 0):
        return _prepare_fp4(qt, args.group_size)

    if (qt.format != CompressionFormat.pack_quantized.value or args is None
            or args.num_bits not in range(2, 9)
            or args.strategy != QuantizationStrategy.GROUP.value
            or len(qt.shape) != 2 or qt.shape[1] % args.group_size != 0):
        return qt
    n, k = qt.shape
    meta = (n, k, args.group_size)
    order = None
    if qt.g_idx is not None:
        # actorder: permute columns so quant groups are contiguous; the
        # matmul gathers x by the same permutation
        order = torch.argsort(qt.g_idx.to(torch.int64), stable=True)

    if args.num_bits != 4:
        if qt.zero_point is not None and args.num_bits >= 8:
            return qt  # 8-bit q - zp does not fit int8: the JAX package
            #            keeps it on the non-kernel path too
        return _prepare_e8(qt, order)
    layout = _w4_layout(w4_layout)
    if layout == "packed" or (layout == "e8" and qt.zero_point is not None):
        # asymmetric weights under "e8" fall through to "packed", as in the
        # JAX package
        return _prepare_packed(qt, order)
    if layout == "e8":
        return _prepare_e8(qt, order)

    packed = qt.weight_packed
    if order is not None:
        packed = pack_to_int32(
            unpack_from_int32(packed, 4, qt.shape).index_select(1, order), 4)
    zp = _unpacked_zero_point(qt, 4)
    return dataclasses.replace(
        qt,
        kernel_packed=packed.contiguous(),
        kernel_scales=qt.scale.to(torch.float32).t().contiguous(),
        kernel_zp=(zp.to(torch.float32).t().contiguous()
                   if zp is not None else None),
        kernel_perm=order,
        kernel_meta=("w4a16", *meta),
    )


def _prepare_e8(qt: QuantizedTensor, order) -> QuantizedTensor:
    """Grouped-int8 kernel layout: (N, K) signed int8 holding q - zp
    (columns in ``order`` for actorder checkpoints) and (K/g, N) f32
    scales."""
    args = qt.scheme.weights
    n, k = qt.shape
    q = unpack_from_int32(qt.weight_packed, args.num_bits, qt.shape)
    if order is not None:
        q = q.index_select(1, order)
    zp = _unpacked_zero_point(qt, args.num_bits)
    if zp is not None:  # |q - zp| <= 127 below 8 bits
        q = (q.to(torch.int16) - zp.to(torch.int16).repeat_interleave(
            args.group_size, dim=1)).to(torch.int8)
    return dataclasses.replace(
        qt, kernel_packed=q.contiguous(),
        kernel_scales=qt.scale.to(torch.float32).t().contiguous(),
        kernel_perm=order, kernel_meta=("w4e8", n, k, args.group_size))


def _prepare_packed(qt: QuantizedTensor, order) -> QuantizedTensor:
    """The int32 8-plane layout, as the JAX prepare builds it: offset codes
    u = q + 8 (columns in ``order`` for actorder checkpoints), K padded to
    a multiple of 8 groups with u = 8, repacked to (K_pad/8, N) words;
    scales and zero points (K_pad/g, N) f32, padded groups at scale 0."""
    n, k = qt.shape
    g = qt.scheme.weights.group_size
    k_pad, tk = padded_k(k, g), choose_k_tile(k, g)
    u = unpack_from_int32(qt.weight_packed, 4, qt.shape).to(torch.int32) + 8
    if order is not None:
        u = u.index_select(1, order)
    words = repack_w4_for_kernel(F.pad(u, (0, k_pad - k), value=8), 4,
                                 k_pad, tk)
    g_pad = k_pad // g - qt.scale.shape[-1]

    def kernel_groups(t):  # (N, K/g) -> (K_pad/g, N) f32, zero rows padded
        t = F.pad(t.to(torch.float32).t(), (0, 0, 0, g_pad))
        return retile_groups(t, k_pad, tk, g).contiguous()

    zp = _unpacked_zero_point(qt, 4)
    return dataclasses.replace(
        qt, kernel_packed=words.contiguous(),
        kernel_scales=kernel_groups(qt.scale),
        kernel_zp=kernel_groups(zp) if zp is not None else None,
        kernel_perm=order, kernel_meta=("w4packed", n, k, g))


def _prepare_fp4(qt: QuantizedTensor, group_size: int) -> QuantizedTensor:
    """NVFP4 / MXFP4 kernel layout: the checkpoint's (N, K/2) codes as they
    are, and (K/g, N) f32 scales: f32(e4m3 scale) / f32(global scale) for
    NVFP4, the E8M0 power of two for MXFP4 (as the JAX prepare computes
    them)."""
    n, k = qt.shape
    scale = qt.scale
    if scale.dtype == torch.uint8:  # MX E8M0
        scale = decompress_mx_scale(scale)
    scale = scale.to(torch.float32)
    if qt.global_scale is not None:
        # a (1, 1) tensor on the scale's device: CUDA divides by a 0-dim
        # CPU tensor as a multiply by its reciprocal
        scale = scale / qt.global_scale.to(device=scale.device,
                                           dtype=torch.float32).reshape(1, 1)
    return dataclasses.replace(
        qt, kernel_packed=qt.weight_packed.contiguous(),
        kernel_scales=scale.t().contiguous(),
        kernel_meta=("fp4", n, k, group_size))


def _w4_layout(layout: str | None = None) -> str:
    """The 4-bit kernel layout (``layout``, else flags.w4_layout): "b8"
    (the int4 words; also for "auto"), "e8" or "packed"."""
    from compressed_tensors_tpu_torch.flags import FLAGS

    layout = layout or FLAGS.w4_layout
    if layout not in ("auto", "b8", "e8", "packed"):
        raise ValueError(f"w4_layout={layout!r}")
    return "b8" if layout == "auto" else layout


def _w4_mode() -> str:
    """The plane layout's decode mode (see flags.w4_mode)."""
    from compressed_tensors_tpu_torch.flags import FLAGS

    if FLAGS.w4_mode not in PLANE_MODES:
        raise ValueError(f"w4_mode={FLAGS.w4_mode!r}")
    return FLAGS.w4_mode


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


def _dense_above(m_rows: int) -> bool:
    """Whether a 4-bit linear at bf16 activations runs dequantized at
    ``m_rows`` rows (see flags.w4_dense_m; 0, the default, is never)."""
    from compressed_tensors_tpu_torch.flags import FLAGS

    return (FLAGS.w4_dense_m > 0 and FLAGS.w4_act != "int8"
            and m_rows >= FLAGS.w4_dense_m)


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


# the tensor fields of a QuantizedTensor, which gain a leading expert dim
# when experts stack, and those of the checkpoint layout among them
_TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(QuantizedTensor)
                       if f.name not in ("kernel_meta", "format", "shape",
                                         "scheme"))
_CHECKPOINT_FIELDS = ("weight", "weight_packed", "scale", "zero_point",
                      "g_idx", "global_scale", "input_global_scale", "bias")


def expert_slice(qt: QuantizedTensor, e: int) -> QuantizedTensor:
    """Expert ``e`` of a stacked (E, N, K) QuantizedTensor, in checkpoint
    layout."""
    return QuantizedTensor(
        **{f: getattr(qt, f)[e] for f in _CHECKPOINT_FIELDS
           if getattr(qt, f) is not None},
        format=qt.format, shape=tuple(qt.shape[1:]), scheme=qt.scheme)


def stack_quantized_tensors(qts: list[QuantizedTensor]) -> QuantizedTensor:
    """Stack per-expert QuantizedTensors into one with a leading expert dim
    on every tensor field (the checkpoint's slice-wise 3-D layout, and the
    kernel layouts when the experts have them). All experts must share
    format and shape."""
    first = qts[0]
    for qt in qts[1:]:
        if qt.format != first.format or qt.shape != first.shape:
            raise ValueError("experts must share format and shape to stack")
    fields = {}
    for name in _TENSOR_FIELDS:
        values = [getattr(qt, name) for qt in qts]
        if any((v is None) != (values[0] is None) for v in values):
            raise ValueError(f"experts must all have {name} or none")
        fields[name] = (torch.stack(values) if values[0] is not None
                        else None)
    return dataclasses.replace(first, shape=(len(qts), *first.shape),
                               **fields)


def prepare_experts_for_kernels(qt: QuantizedTensor,
                                w4_layout: str | None = None
                                ) -> QuantizedTensor:
    """The stacked-expert (3-D) analogue of ``prepare_for_kernels``:
    prepare each expert slice and stack the kernel layouts, so that one
    expert-batched kernel launch serves every expert. Only the WnA16
    layouts those kernels take stack -- the int4 words (``"w4a16"``) and
    the grouped int8 (``"w4e8"``); every other layout (W8A8, fp4, the
    plane layout, actorder experts with a column permutation, 2:4 sparse
    experts) returns unchanged, as in the JAX package."""
    if (qt.kernel_packed is not None or len(qt.shape) != 3
            or qt.sparse_values is not None):
        return qt
    prepped = [prepare_for_kernels(expert_slice(qt, e), w4_layout)
               for e in range(qt.shape[0])]
    first = prepped[0]
    if first.kernel_meta is None or first.kernel_meta[0] not in ("w4a16",
                                                                 "w4e8"):
        return qt
    if any(p.kernel_perm is not None for p in prepped):
        return qt  # actorder experts stay on the non-kernel path
    kernel = {f: (torch.stack([getattr(p, f) for p in prepped])
                  if getattr(first, f) is not None else None)
              for f in ("kernel_scales", "kernel_zp")}
    # the int4 words are the checkpoint's own: no second copy
    kernel["kernel_packed"] = (
        qt.weight_packed.contiguous() if first.kernel_meta[0] == "w4a16"
        else torch.stack([p.kernel_packed for p in prepped]))
    return dataclasses.replace(qt, kernel_meta=first.kernel_meta, **kernel)


def quantized_matmul_experts(x: torch.Tensor, qt: QuantizedTensor,
                             use_kernels: bool = True) -> torch.Tensor:
    """Batched expert matmul: y[e] = x[e] @ W[e]^T (+ bias[e]) for the
    (E, C, K) dispatch buffer and stacked expert weights.

    With ``use_kernels`` and a stacked kernel layout, one expert-batched
    launch: the int4 words through ``w4a16_experts_matmul`` in the mode
    ``_w4b8_mode`` picks for C rows (int4b, or a8b), the grouped int8
    through ``w4_e8_experts_matmul`` (their plain versions for CPU
    tensors). Otherwise the JAX package's non-kernel path: W8A8-int and
    FP8 experts with dynamic per-token activations as one batched product
    over E (exact integer sums for int8; the JAX package runs these
    outside any Pallas kernel), everything else dequantized and one
    batched matmul.
    """
    scheme = qt.scheme
    input_args = scheme.input_activations if scheme is not None else None
    weights_args = scheme.weights if scheme is not None else None
    E, C, K = x.shape
    kind = qt.kernel_meta[0] if qt.kernel_meta is not None else None

    if kernels_enabled(use_kernels) and kind in ("w4a16", "w4e8"):
        n, k, group_size = qt.kernel_meta[1:4]
        x = x.contiguous()
        if kind == "w4a16":
            out = w4a16_experts_matmul(
                x, qt.kernel_packed, qt.kernel_scales, qt.kernel_zp, n=n,
                k=k, group_size=group_size, mode=_w4b8_mode(C, n, k))
        else:
            out = w4_e8_experts_matmul(x, qt.kernel_packed, qt.kernel_scales,
                                       n=n, k=k, group_size=group_size)
        if qt.bias is not None:
            out = out + qt.bias.to(out.dtype)[:, None, :]
        return out

    w8 = (qt.weight is not None and qt.sparse_values is None
          and input_args is not None and input_args.dynamic is True
          and input_args.num_bits == 8 and weights_args is not None
          and weights_args.strategy in _W8_STRATEGIES)
    if w8 and qt.weight.dtype == torch.int8 and input_args.type == "int":
        x_scale, _ = compute_dynamic_scales_and_zp(x, input_args)  # (E, C, 1)
        x_q = quantize(x, x_scale, None, input_args, dtype=torch.int8)
        acc = torch.matmul(x_q.to(torch.float64),
                           qt.weight.to(torch.float64).transpose(1, 2))
        w_scale = qt.scale.to(torch.float32).reshape(E, 1, -1)
        out = acc.to(torch.float32) * x_scale.to(torch.float32) * w_scale
        return out.to(x.dtype)
    if (w8 and qt.weight.dtype == torch.float8_e4m3fn
            and input_args.type == "float"):
        x_scale, _ = compute_dynamic_scales_and_zp(x, input_args)
        x_q = quantize(x, x_scale, None, input_args, dtype=qt.weight.dtype)
        acc = torch.matmul(x_q.to(torch.float32),
                           qt.weight.to(torch.float32).transpose(1, 2))
        w_scale = qt.scale.to(torch.float32).reshape(E, 1, -1)
        return (acc * x_scale.to(torch.float32) * w_scale).to(x.dtype)

    w = materialize_weight(qt, dtype=x.dtype)  # (E, N, K)
    out = torch.matmul(x.to(torch.float32),
                       w.to(torch.float32).transpose(1, 2)).to(x.dtype)
    if qt.bias is not None:
        out = out + qt.bias.to(out.dtype)[:, None, :]
    return out


def quantized_matmul(x: torch.Tensor, qt: QuantizedTensor,
                     use_kernels: bool = True) -> torch.Tensor:
    """y = x @ W^T (+ bias) with W in compressed form.

    With ``use_kernels`` and a kernel layout, the W4A16 (int4 words or the
    plane layout in ``w4_mode``), fp4, grouped-int8 and W8A8 kernels run
    (their plain versions for CPU tensors); otherwise
    the non-kernel path of the JAX package: W8A8-int / fp8 dynamic
    products, or dequantize then one plain matmul (NVFP4 with activations
    included: neither package quantizes fp4 activations).
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
    lead = x.shape[:-1]
    use_kernels = kernels_enabled(use_kernels)
    if (use_kernels and kind in ("w4a16", "w4packed", "w4e8")
            and _dense_above(x.numel() // x.shape[-1])
            and qt.weight_packed is not None):
        # the w4_dense_m opt-in: dequantize the weight once, one matmul
        out = torch.matmul(x, materialize_weight(qt, dtype=x.dtype).t())
    elif use_kernels and kind in ("w4a16", "w4packed", "w4e8", "fp4",
                                  "w8a8"):
        if qt.kernel_perm is not None:
            x = x.index_select(-1, qt.kernel_perm)
        n, k = qt.kernel_meta[1:3]
        x2 = x.reshape(-1, k).contiguous()
        if kind == "w8a8":
            out = w8a8_matmul(x2, qt.kernel_packed, qt.kernel_scales, n=n, k=k)
        elif kind == "w4a16":
            out = w4a16_matmul(x2, qt.kernel_packed,
                               qt.kernel_scales, qt.kernel_zp, n=n, k=k,
                               group_size=qt.kernel_meta[3],
                               mode=_w4b8_mode(x2.shape[0], n, k))
        elif kind == "w4packed":
            out = w4a16_planes_matmul(
                x2, qt.kernel_packed, qt.kernel_scales, qt.kernel_zp, n=n,
                k=qt.kernel_packed.shape[0] * 8,
                group_size=qt.kernel_meta[3], mode=_w4_mode())
        else:
            matmul = w4a16_fp4_matmul if kind == "fp4" else w4_e8_matmul
            out = matmul(x2, qt.kernel_packed, qt.kernel_scales, n=n, k=k,
                         group_size=qt.kernel_meta[3])
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
