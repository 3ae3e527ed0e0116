"""One decode step of GQA attention on the stacked KV cache.

Replaces ``compressed_tensors_tpu/ops/kernels/decode_attention.py:
decode_attention`` with the hand-written Hopper kernel in
``csrc/decode_attention.cu``: one block per (kv head, batch row) writes the
step's K/V row in place at ``lengths[b]`` (rows with a negative length are
left untouched), then attends the group's query heads over positions
0..lengths[b] on the tensor cores, with the probabilities normalized by
each head's exact max and sum and rounded to q's dtype before P.V as in
the TPU kernel. ``block_decode_form`` picks how: up to ``SCORE_POSITIONS``
positions the scores stay in shared memory and K and V are read once
("scores"); longer rows recompute the scores in a second pass over K
("recompute"). The cache is (L, B, KVH, S_pad, D): no lane padding of D
and no head packing, which the TPU layout needed for Mosaic's (8, 128)
tiles.

The cache tensors are updated in place, by the kernel and by the plain
version alike; the function returns them for the JAX package's (out,
cache_k, cache_v) contract.

A quantized cache (fp8 e4m3 or int8, with k/v scales per tensor or per kv
head) follows the TPU kernel's arithmetic: the new row is written as x /
scale in the cache type, cached values are converted raw, k_scale folds
into q (rounded to q's dtype) and v_scale multiplies the f32 output.

Bound on the H100: the bytes of the cache prefix each row reads,
2 * B*KVH*(len+1)*D*itemsize per step and layer, against 3.35 TB/s. The
model runs it for caches with S_pad < 512 under ``decode_attn="auto"``, as
the JAX package does; ``flash_decode.py`` serves the larger ones.

``decode_attention`` launches the kernel for CUDA tensors and uses
``decode_attention_plain`` only for CPU tensors. Launches on a bf16 cache
count in ``decode_attention.launches``, on an fp8 or int8 cache in
``decode_attention.scaled_launches``.

MLA's latent head (one kv head whose K and V widths are not a GQA head
width: DeepSeek V2-Lite's K rows [c_kv ; k_pe] of 576 and V rows c_kv of
512) takes the latent-head kernel B5-L instead (``csrc/mla_decode.cu``,
entry point ``ct_latent_decode``): the same contract with V narrower than
K and the softmax scale 1/sqrt(``true_d``), as the JAX package calls its
kernel with ``kvh=1, rep=h, d=Dp, true_d``. Its plain version is
``latent_decode_attention_plain``; its launches count in
``decode_attention.latent_launches``. It takes any number of query heads
(DeepSeek-V2/V3's 128) in blocks of ``LATENT_HEADS``, on a persistent grid
that cuts the live tiles of ``LATENT_TILE`` positions into
``latent_ranges`` contiguous ranges (``latent_segments`` gives the order
of its sums), and a merge pass for the rows a range boundary cuts.
"""

from __future__ import annotations

import math

import torch

from compressed_tensors_tpu_torch.ops.kernels import _build
from compressed_tensors_tpu_torch.utils.dtypes import byte_view

__all__ = ["decode_attention", "decode_attention_plain",
           "latent_decode_attention_plain", "is_latent_head",
           "block_decode_form", "SCORE_POSITIONS", "LATENT_TILE",
           "LATENT_HEADS", "LATENT_FLIP_REL", "latent_ranges",
           "latent_segments"]

# cache element type -> ct::CacheKind of csrc/common.cuh
_CACHE_KINDS = {torch.bfloat16: 0, torch.float8_e4m3fn: 1, torch.int8: 2}
# the longest cache whose f32 scores (16 heads) the kernel keeps in shared
# memory: every cache that decode_attn="auto" sends here (S_pad < 512)
SCORE_POSITIONS = 512
# positions a tile of the latent-head kernels (csrc/mla_decode.cu)
LATENT_TILE = 16
# query heads a block of the latent-head kernels (one wgmma M tile)
LATENT_HEADS = 64
# the H100's SMs: the latent-head kernels' ranges on a CPU tensor
LATENT_CTAS = 132
# the widest latent K row the latent-head kernels take
LATENT_MAX_D = 640
# how far (relative) the latent-head kernels' f32 probabilities may stand
# from the plain version's in the kernels' order: the scores are the same
# bf16 products summed in another order, which moves a probability by
# about 2^-17 of itself at most on 576-wide rows of N(0, 1) draws (twice
# the largest f32-to-f64 difference, 2^-18.2), and 2^-14 leaves a factor
# of 8
LATENT_FLIP_REL = 2**-14


def block_decode_form(s_pad: int) -> str:
    """The block decode kernel's form for a cache of ``s_pad`` positions:
    "scores" (the scores in shared memory, K and V each read once) up to
    ``SCORE_POSITIONS``, else "recompute" (the scores formed again in a
    second pass over K)."""
    return "scores" if s_pad <= SCORE_POSITIONS else "recompute"


def _layer_views(cache_k, cache_v, layer):
    if cache_k.dim() == 5:
        if layer is None:
            raise ValueError("a stacked (L, B, KVH, S_pad, D) cache needs "
                             "the layer index")
        return cache_k[layer], cache_v[layer]
    return cache_k, cache_v


def is_latent_head(new_k, new_v) -> bool:
    """MLA's latent head: one kv head whose (K, V) widths are not a GQA
    head's (equal, 64 or 128); the latent-head kernels serve it."""
    dk, dv = new_k.shape[-1], new_v.shape[-1]
    return new_k.shape[1] == 1 and not (dk == dv and dk in (64, 128))


def _check_placement(name, q, new_k, new_v, cache_k, cache_v, lengths):
    """The checks every decode kernel shares: contiguous operands on one
    device, bf16 q and new rows, a bf16/fp8/int8 cache, (B,) int32
    lengths."""
    for t in (q, new_k, new_v, cache_k, cache_v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} operands must be contiguous on one "
                             "device")
    if any(t.dtype != torch.bfloat16 for t in (q, new_k, new_v)):
        raise ValueError(f"{name} takes bf16 q and new k/v")
    if cache_k.dtype not in _CACHE_KINDS or cache_v.dtype != cache_k.dtype:
        raise NotImplementedError(
            f"{name} kernel serves bf16, fp8 e4m3 and int8 caches, got "
            f"{cache_k.dtype}")
    if (lengths.dtype != torch.int32 or lengths.device != q.device
            or tuple(lengths.shape) != (q.shape[0],)):
        raise ValueError("lengths must be (B,) int32 on q's device")


def check_latent_operands(name, q, new_k, new_v, cache_k, cache_v, lengths):
    """Raise on operands the latent-head kernels (B5-L, B7-L) do not take;
    returns (B, H, Dk, Dv)."""
    B, H, Dk = q.shape
    Dv = new_v.shape[-1]
    if not (Dk % 64 == 0 and Dv % 64 == 0 and 64 <= Dv <= Dk <= LATENT_MAX_D
            and H >= 1):
        raise NotImplementedError(
            f"{name} latent-head kernel serves K and V widths that are "
            f"multiples of 64 with V <= K <= {LATENT_MAX_D}, got K={Dk}, "
            f"V={Dv}")
    if (tuple(new_k.shape) != (B, 1, Dk) or tuple(new_v.shape) != (B, 1, Dv)
            or cache_k.shape[-1] != Dk or cache_v.shape[-1] != Dv
            or cache_k.shape[:-1] != cache_v.shape[:-1]
            or cache_k.shape[-3] != 1):
        raise ValueError(f"{name} shape mismatch")
    _check_placement(name, q, new_k, new_v, cache_k, cache_v, lengths)
    return B, H, Dk, Dv


def check_decode_operands(name, q, new_k, new_v, cache_k, cache_v,
                          lengths):
    """Raise on operands the CUDA decode kernels (block, flash, paged) do
    not take; returns (B, H, D, KVH, rep)."""
    B, H, D = q.shape
    KVH = new_k.shape[1]
    rep = H // KVH if KVH else 0
    if D not in (64, 128) or H != KVH * rep or rep > 16:
        raise NotImplementedError(
            f"{name} kernel serves D in (64, 128) and H/KVH <= 16, got D={D}, "
            f"H={H}, KVH={KVH}")
    if (tuple(new_k.shape) != (B, KVH, D) or new_v.shape != new_k.shape
            or cache_v.shape != cache_k.shape or cache_k.shape[-1] != D
            or cache_k.shape[-3] != KVH):
        raise ValueError(f"{name} shape mismatch")
    _check_placement(name, q, new_k, new_v, cache_k, cache_v, lengths)
    return B, H, D, KVH, rep


def kernel_scales(name, q, cache_k, k_scale, v_scale, per_head=False):
    """The cache kind and scale operands of a decode kernel launch:
    (kind, k_scale, v_scale, scale_stride, scaled). A bf16 cache ignores
    scales (the TPU kernels take them only for a cache of another dtype
    than q); an fp8 or int8 cache needs them, per tensor (stride 0) or, if
    ``per_head``, one per kv head (stride 1), as f32 on q's device."""
    kind = _CACHE_KINDS[cache_k.dtype]
    if kind == 0:
        return kind, None, None, 0, False
    if k_scale is None or v_scale is None:
        raise NotImplementedError(
            f"{name} on a {cache_k.dtype} cache needs k/v scales")
    kvh = cache_k.shape[-3]
    ks, vs = (s.reshape(-1).to(device=q.device, dtype=torch.float32)
              .contiguous() for s in (k_scale, v_scale))
    sizes = (1, kvh) if per_head else (1,)
    if ks.numel() != vs.numel() or ks.numel() not in sizes:
        raise NotImplementedError(
            f"{name} kernel takes k/v scales of {' or '.join(map(str, sizes))}"
            f" values, got {ks.numel()} and {vs.numel()}")
    return kind, ks, vs, int(ks.numel() > 1), True


def decode_attention_plain(q, new_k, new_v, cache_k, cache_v, lengths, *,
                           layer=None, k_scale=None, v_scale=None,
                           true_d=None):
    """Plain PyTorch version: the in-place row write (the new K/V in the
    cache's representation), then masked softmax attention in f32 with the
    normalized probabilities cast to q's dtype before P.V, the TPU kernel's
    numerics. On a cache of another dtype than q with k/v scales, the
    scales fold as in the TPU kernel: cached values are converted raw,
    q * k_scale is rounded to q's dtype and v_scale multiplies the f32
    output, by kv head for per-head scales. Outputs of inactive rows are
    zero."""
    from compressed_tensors_tpu_torch.models.llama import _quantize_to_cache

    ck, cv = _layer_views(cache_k, cache_v, layer)
    B, H, D = q.shape
    KVH, S_pad = ck.shape[1], ck.shape[2]
    rep = H // KVH
    cd = q.dtype
    lengths = lengths.to(torch.int64)
    rows = torch.nonzero((lengths >= 0) & (lengths < S_pad)).reshape(-1)
    for cache, new, scale in ((ck, new_k, k_scale), (cv, new_v, v_scale)):
        byte_view(cache)[rows, :, lengths[rows]] = byte_view(
            _quantize_to_cache(new[rows], scale, cache.dtype, head_axis=1))

    folded = k_scale is not None and ck.dtype != cd

    def head_scales(scale):  # (1, KVH, 1, 1) f32, per tensor or per head
        return scale.reshape(-1).to(torch.float32).expand(KVH).reshape(
            1, KVH, 1, 1)

    qg = q.reshape(B, KVH, rep, D).to(torch.float32)
    if folded:
        qg = (qg * head_scales(k_scale)).to(cd).to(torch.float32)
    keys, values = (c.to(cd).to(torch.float32) for c in (ck, cv))
    scores = torch.einsum("bkrd,bksd->bkrs", qg, keys) * (
        1.0 / math.sqrt(true_d or D))
    pos = torch.arange(S_pad, device=q.device)
    mask = pos[None, :] <= lengths[:, None]                  # (B, S_pad)
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(cd).to(torch.float32)
    out = torch.einsum("bkrs,bksd->bkrd", probs, values)
    if folded:
        out = out * head_scales(v_scale)
    out = out.reshape(B, H, D)
    out = torch.where((lengths >= 0)[:, None, None], out,
                      torch.zeros_like(out))
    return out.to(cd), cache_k, cache_v


def latent_ranges(heads, device=None) -> int:
    """Ranges of the latent-head kernels' persistent grid: the SMs of
    ``device`` (``LATENT_CTAS`` for the CPU) over the blocks of
    ``LATENT_HEADS`` query heads, at least 1."""
    sms = LATENT_CTAS
    if device is not None and torch.device(device).type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, sms // -(-heads // LATENT_HEADS))


def latent_segments(lengths, capacity, ranges):
    """The latent-head kernels' schedule as (B, capacity // LATENT_TILE + 1)
    bool: True at each tile that starts a segment of a row. Row b holds
    min(lengths[b], capacity) // LATENT_TILE + 1 live tiles (none when
    inactive), the rows' tiles in order number 0..T-1, and the ranges
    floor(r T / ranges) .. floor((r + 1) T / ranges) cut them: a segment
    starts at a row's first tile and at each range's first tile."""
    lengths = lengths.to(torch.int64)
    n = torch.where(lengths >= 0,
                    lengths.clamp(max=capacity) // LATENT_TILE + 1, 0)
    first = torch.cumsum(n, 0) - n                   # a row's first tile
    total = int(n.sum())
    j = torch.arange(capacity // LATENT_TILE + 1, device=lengths.device)
    cuts = torch.arange(1, ranges, device=lengths.device) * total // ranges
    cut = torch.isin(first[:, None] + j, cuts) & (j < n[:, None])
    return (j == 0) | cut


def latent_decode_attention_plain(q, new_k, new_v, cache_k, cache_v,
                                  lengths, *, layer=None, k_scale=None,
                                  v_scale=None, true_d=None,
                                  kernel_order=False, out_dtype=None,
                                  flip_rel=None, ranges=None):
    """B5-L's plain version: the in-place row write at lengths[b] (K rows
    of width Dk, V rows of width Dv, in the cache's representation), then
    ``flash_decode.attend_plain`` over the row's cached prefix with the
    softmax scale 1/sqrt(``true_d``): the TPU kernel's numerics (q *
    k_scale rounded to q's dtype, the probabilities rounded to q's dtype
    before P.V, v_scale onto the f32 output). ``kernel_order`` sums in the
    CUDA kernel's order (tiles of ``LATENT_TILE`` positions, an online
    softmax over each segment of ``latent_segments`` with ``ranges``, by
    default ``latent_ranges`` of the head count on q's device), as
    ``chip_smoke.py`` compares it, with ``out_dtype`` f32 for the
    unrounded result; with
    ``flip_rel`` (``LATENT_FLIP_REL``) the first item is (output, flip),
    flip bounding the kernels' other rounding of probabilities that lie
    near a rounding midpoint (``flash_decode.attend_plain``). Outputs of
    inactive rows are zero."""
    from compressed_tensors_tpu_torch.models.llama import _quantize_to_cache
    from compressed_tensors_tpu_torch.ops.kernels.flash_decode import (
        attend_plain,
    )

    ck, cv = _layer_views(cache_k, cache_v, layer)
    nk_c = _quantize_to_cache(new_k, k_scale, ck.dtype, head_axis=1)
    nv_c = _quantize_to_cache(new_v, v_scale, cv.dtype, head_axis=1)
    segments = None
    if kernel_order:
        segments = latent_segments(
            lengths, ck.shape[2],
            ranges or latent_ranges(q.shape[1], q.device))
    out = attend_plain(
        q, nk_c, nv_c, ck, cv, lengths, k_scale, v_scale,
        tile=LATENT_TILE if kernel_order else None, segments=segments,
        inv_sqrt_d=1.0 / math.sqrt(true_d or q.shape[-1]),
        out_dtype=out_dtype, flip_rel=flip_rel)
    lengths = lengths.to(torch.int64)
    rows = torch.nonzero((lengths >= 0) & (lengths < ck.shape[2])).reshape(-1)
    byte_view(ck)[rows, :, lengths[rows]] = byte_view(nk_c[rows])
    byte_view(cv)[rows, :, lengths[rows]] = byte_view(nv_c[rows])
    return out, cache_k, cache_v


def latent_scratch(B, H, Dv, ranges, device):
    """The latent-head kernels' scratch: (f32 partials, their (max, sum)
    pairs' pointer, the row prefix sums (B + 1,) int32). Two partial slots
    a block of the grid (``ranges`` times the head blocks), each
    ``LATENT_HEADS`` rows of Dv outputs and then the pairs."""
    slots = 2 * ranges * -(-H // LATENT_HEADS) * LATENT_HEADS
    part = torch.empty(slots * (Dv + 2), dtype=torch.float32, device=device)
    prefix = torch.empty(B + 1, dtype=torch.int32, device=device)
    return part, part.data_ptr() + slots * Dv * 4, prefix


def _latent_decode(q, new_k, new_v, cache_k, cache_v, lengths, layer,
                   k_scale, v_scale, true_d, ranges=None):
    """B5-L on CUDA tensors: one call of ``ct_latent_decode`` (the kernel
    and its merge pass) over ``ranges`` ranges (``latent_ranges`` of the
    head count by default)."""
    B, H, Dk, Dv = check_latent_operands(
        "decode_attention", q, new_k, new_v, cache_k, cache_v, lengths)
    kind, ks, vs, _, scaled = kernel_scales(
        "decode_attention", q, cache_k, k_scale, v_scale)
    if cache_k.dim() != 5 or cache_k.shape[1] != B:
        raise ValueError("the latent decode_attention needs the (L, B, 1, "
                         "S_pad, D) cache")
    L, _, _, S_pad, _ = cache_k.shape
    if layer is None or not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for {L} cache layers")
    ranges = ranges or latent_ranges(H, q.device)
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
    part, part_ml, prefix = latent_scratch(B, H, Dv, ranges, q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.ct_latent_decode(
            q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
            cache_k.data_ptr(), cache_v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), ks.data_ptr() if scaled else None,
            vs.data_ptr() if scaled else None, part_ml, part.data_ptr(),
            prefix.data_ptr(), B, H, S_pad, Dk, Dv, layer, L, kind, ranges,
            1.0 / math.sqrt(true_d or Dk),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "decode_attention (latent head)")
    decode_attention.latent_launches += 1
    return out, cache_k, cache_v


def decode_attention(q: torch.Tensor, new_k: torch.Tensor,
                     new_v: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, lengths: torch.Tensor, *,
                     layer: int | None = None,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None,
                     true_d: int | None = None):
    """q (B, H, D), new_k/new_v (B, KVH, D) post-RoPE; cache (L, B, KVH,
    S_pad, D) with ``layer``, or (B, KVH, S_pad, D); lengths (B,) int32,
    negative = inactive. Returns (out (B, H, D), cache_k, cache_v), the
    caches being the same tensors, updated in place. ``true_d`` sets the
    softmax scale 1/sqrt(true_d) (D by default). MLA's latent head
    (``is_latent_head``: KVH 1, new_v and the V cache of width Dv) gives
    out (B, H, Dv) through B5-L."""
    latent = is_latent_head(new_k, new_v)
    if q.device.type == "cpu":
        plain = (latent_decode_attention_plain if latent
                 else decode_attention_plain)
        return plain(q, new_k, new_v, cache_k, cache_v, lengths, layer=layer,
                     k_scale=k_scale, v_scale=v_scale, true_d=true_d)
    if latent:
        return _latent_decode(q, new_k, new_v, cache_k, cache_v, lengths,
                              layer, k_scale, v_scale, true_d)
    B, H, D, KVH, rep = check_decode_operands(
        "decode_attention", q, new_k, new_v, cache_k, cache_v, lengths)
    kind, ks, vs, stride, scaled = kernel_scales(
        "decode_attention", q, cache_k, k_scale, v_scale, per_head=True)
    if cache_k.dim() == 4:
        cache_shape5 = (1, *cache_k.shape)
        layer = 0
    else:
        cache_shape5 = tuple(cache_k.shape)
    L, Bc, _, S_pad, _ = cache_shape5
    if layer is None or not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for {L} cache layers")
    if Bc != B:
        raise ValueError("decode_attention shape mismatch")
    out = torch.empty_like(q)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.ct_decode_attention(
            q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
            cache_k.data_ptr(), cache_v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), ks.data_ptr() if scaled else None,
            vs.data_ptr() if scaled else None, B, KVH, rep, S_pad, D, layer,
            kind, stride, int(block_decode_form(S_pad) == "scores"),
            1.0 / math.sqrt(true_d or D),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "decode_attention")
    if scaled:
        decode_attention.scaled_launches += 1
    else:
        decode_attention.launches += 1
    return out, cache_k, cache_v


decode_attention.launches = 0
decode_attention.scaled_launches = 0
decode_attention.latent_launches = 0
