"""Length-aware decode attention on the dense slab cache (flash decode).

Replaces ``compressed_tensors_tpu/ops/kernels/flash_decode.py:
flash_decode_attention`` with the hand-written Hopper kernel in
``csrc/paged_decode.cu`` (entry point ``ct_flash_decode``), which shares
its body with the paged pool's kernel (``paged_decode.py``): the keys of
each (kv head, batch row) split into runs of ``SPLIT_TILES`` 64-position
tiles, one block each, streamed in the cache's own type and scored on the
tensor cores with an f32 online softmax whose unnormalized probabilities
are rounded to q's dtype before P.V, as the TPU kernel does; a second pass
merges a row's splits when the cache holds more than one. The block whose split holds position lengths[b]
writes the step's K/V row there in place and folds it from registers. A
row with a negative length is inactive: its output is zero and its cache
bytes are neither read nor written.

The cache is (L, B, KVH, S_pad, D) with S_pad a multiple of the chunk (64),
updated in place; the function returns it for the JAX package's (out,
cache_k, cache_v) contract.

A quantized cache (fp8 e4m3 or int8, with per-tensor k/v scales) follows
the TPU kernel's arithmetic: the new row is written as x / scale in the
cache type, cached values are converted raw, k_scale folds into q (rounded
to q's dtype) and v_scale multiplies the normalized f32 output.

Bound on the H100: the live cache bytes, 2 * sum(len + 1) * KVH * D *
itemsize per layer, against 3.35 TB/s.

``flash_decode_attention`` launches the kernel for CUDA tensors and uses
``flash_decode_attention_plain`` only for CPU tensors. Launches on a bf16
cache count in ``flash_decode_attention.launches``, on an fp8 or int8
cache in ``flash_decode_attention.scaled_launches``.
"""

from __future__ import annotations

import math

import torch

from compressed_tensors_tpu_torch.ops.kernels import _build
from compressed_tensors_tpu_torch.utils.dtypes import byte_view
from compressed_tensors_tpu_torch.ops.kernels.decode_attention import (
    check_decode_operands,
    kernel_scales,
)

__all__ = ["flash_decode_attention", "flash_decode_attention_plain",
           "split_scratch"]

CHUNK = 64  # positions per chunk, as the TPU kernel's default
# 64-position tiles a split of the kernels' keys, by cache element bytes
SPLIT_TILES = {2: 4, 1: 8}


def split_scratch(B, KVH, rep, D, capacity, itemsize, device):
    """(tiles a split, splits, scratch pointers) of the flash and paged
    decode kernels for rows of up to
    ``capacity`` cached positions (positions 0..capacity, the new token's
    included) in a cache of ``itemsize``-byte elements; ``D`` is the
    output width (the V width). The scratch is one f32 ``torch.empty``
    holding the per-split unnormalized outputs (B, KVH, splits, rep, D)
    and then their (max, sum) pairs (B, KVH, splits, rep, 2): the pointers
    are (pairs, outputs, the tensor that keeps them alive), all None when
    every row fits in one split (its block writes the row)."""
    per = SPLIT_TILES[itemsize]
    span = per * CHUNK
    splits = (capacity + span) // span
    if splits == 1:
        return per, 1, (None, None, None)
    slots = B * KVH * splits * rep
    scratch = torch.empty(slots * (D + 2), dtype=torch.float32,
                          device=device)
    base = scratch.data_ptr()
    return per, splits, (base + slots * D * 4, base, scratch)


def attend_plain(q, new_k_c, new_v_c, keys, values, lengths, k_scale,
                 v_scale, split=None, inv_sqrt_d=None, tile=None,
                 out_dtype=None, flip_rel=None, segments=None):
    """The flash/paged decode arithmetic in plain PyTorch, as the TPU
    kernels compute it: the new token (in its cache representation) plus
    each row's cached positions 0..lengths[b]-1 of ``keys`` (B, KVH, T, D)
    and ``values`` (B, KVH, T, Dv; Dv = D but for MLA's latent head);
    softmax in f32 of the scores times ``inv_sqrt_d`` (1/sqrt(D) by
    default) with the unnormalized probabilities cast to q's dtype before
    P.V. Scalar cache scales fold into q and onto the output, so cached
    values only take a dtype cast. Inactive rows give zeros.

    With ``split`` (positions a split), the order of the CUDA kernel: the
    new token sits at position min(lengths[b], T) after the cached ones,
    each run of ``split`` positions takes its own softmax (max, sum and
    unnormalized output, the probabilities cast against the run's max),
    and the runs merge by their maxima. With ``tile`` too, the order of an
    online softmax: inside a run the tiles of ``tile`` positions update
    one running max, each tile's probabilities cast against the running
    max after that tile. ``segments`` ((B, T // tile + 1) bool, with
    ``tile``) replaces the runs: a row's segment starts at each tile
    marked True (the latent-head kernels' schedule,
    ``decode_attention.latent_segments``). The output is in q's dtype, or
    ``out_dtype`` (f32 to hold a kernel to its unrounded result).

    With ``flip_rel`` (and ``split`` or ``segments``) it returns (output,
    flip): flip (f32, the output's shape) bounds what the probabilities'
    rounding to q's dtype can change when a kernel's f32 probability
    differs from this one's by up to ``flip_rel`` of it (another summation
    order of the scores): each probability that close to a rounding
    midpoint may round to the other neighbour, one ulp, and flip sums
    those ulps times |v| through the same softmax weights."""
    B, H, D = q.shape
    KVH, T, Dv = keys.shape[1], keys.shape[2], values.shape[-1]
    cd = q.dtype
    folded = k_scale is not None and keys.dtype != cd
    qh = ((q.to(torch.float32) * k_scale.to(torch.float32).reshape(()))
          .to(cd) if folded else q)
    qg = qh.to(torch.float32).reshape(B, KVH, H // KVH, D)
    kf, vf = (t.to(cd).to(torch.float32) for t in (keys, values))
    nkf, nvf = (t.to(cd).to(torch.float32) for t in (new_k_c, new_v_c))
    if inv_sqrt_d is None:
        inv_sqrt_d = 1.0 / math.sqrt(D)
    lengths = lengths.to(torch.int64)
    ordered = split is not None or segments is not None
    if flip_rel is not None and not ordered:
        raise ValueError("flip_rel needs the split order")
    if not ordered:
        s_new = torch.einsum("bkrd,bkd->bkr", qg, nkf)[..., None] * inv_sqrt_d
        s_old = torch.einsum("bkrd,bktd->bkrt", qg, kf) * inv_sqrt_d
        valid = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
        s_old = s_old.masked_fill(~valid[:, None, None, :], float("-inf"))
        s = torch.cat([s_new, s_old], dim=-1)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True)
        pr = p.to(cd).to(torch.float32)
        acc = (pr[..., :1] * nvf[:, :, None, :]
               + torch.einsum("bkrt,bktd->bkrd", pr[..., 1:], vf))
        out = acc / l.clamp_min(1e-30)
    else:
        tile = tile or split
        if segments is None:
            starts = (torch.arange(T // tile + 1, device=q.device) * tile
                      % split == 0).expand(B, -1)
        else:
            starts = segments.to(q.device)
        out, flip = _attend_segments(qg, nkf, nvf, kf, vf, lengths, tile,
                                     starts, cd, inv_sqrt_d, flip_rel)
    active = (lengths >= 0)[:, None, None]

    def finish(t):
        if folded:
            t = t * v_scale.to(torch.float32).reshape(())
        t = t.reshape(B, H, Dv)
        return torch.where(active, t, torch.zeros_like(t))

    out = finish(out).to(out_dtype or cd)
    return out if flip_rel is None else (out, finish(flip))


def _rounding_flips(p, pr, cd, rel):
    """Per f32 probability ``p`` rounded to ``pr`` in ``cd``: one ulp of
    ``pr`` where ``p`` lies within ``rel`` * p of a rounding midpoint (a
    nearby value could round to the other neighbour), else 0."""
    mant, e = torch.frexp(pr)                    # pr = mant * 2^e
    ulp = torch.ldexp(torch.full_like(pr, torch.finfo(cd).eps), e - 1)
    below = torch.where(mant == 0.5, ulp / 2, ulp)  # under a power of two
    gap = torch.where(p >= pr, ulp, below) / 2 - (p - pr).abs()
    return torch.where((p > 0) & (gap <= rel * p), ulp, torch.zeros_like(p))


def _attend_segments(qg, nkf, nvf, kf, vf, lengths, tile, starts, cd,
                     inv_sqrt_d, flip_rel=None):
    """``attend_plain``'s ordered form: tiles of ``tile`` positions, an
    online softmax over each segment's tiles (a segment starting at each
    tile where ``starts`` (B, NT) is True), the segments merged by their
    maxima. f32 (B, KVH, rep, Dv) outputs, and their rounding-flip bound
    with ``flip_rel`` (else None)."""
    B, KVH, T, D = kf.shape
    Dv = vf.shape[-1]
    NT = T // tile + 1
    n = NT * tile
    cached = lengths.clamp(0, T)
    rows = torch.arange(B, device=kf.device)
    kx = torch.cat([kf, kf.new_zeros(B, KVH, n - T, D)], dim=2)
    vx = torch.cat([vf, vf.new_zeros(B, KVH, n - T, Dv)], dim=2)
    kx[rows, :, cached] = nkf
    vx[rows, :, cached] = nvf
    s = torch.einsum("bkrd,bktd->bkrt", qg, kx) * inv_sqrt_d
    valid = torch.arange(n, device=kf.device)[None, :] <= cached[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    s = s.reshape(*s.shape[:3], NT, tile)           # (B, KVH, R, NT, tile)
    tmax = s.amax(dim=-1)
    starts = starts[:, None, None, :]
    run = torch.empty_like(tmax)                    # the running max
    cur = tmax[..., 0]
    run[..., 0] = cur
    for j in range(1, NT):
        cur = torch.where(starts[..., j], tmax[..., j],
                          torch.maximum(cur, tmax[..., j]))
        run[..., j] = cur
    ninf = torch.isinf(run)
    run_use = torch.where(ninf, torch.zeros_like(run), run)
    p = torch.exp(s - run_use[..., None])
    pr = p.to(cd).to(torch.float32)
    vt = vx.reshape(B, KVH, NT, tile, Dv)
    # each tile's sums carried to its segment's final max
    seg = (torch.cumsum(starts.to(torch.int64), dim=-1) - 1).clamp_min(0)
    seg = seg.expand_as(run)
    m = torch.full_like(run, float("-inf")).scatter_reduce(
        -1, seg, run, "amax")                       # (B, KVH, R, NT segs)
    m_use = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    w = torch.where(ninf, torch.zeros_like(run),
                    torch.exp(run_use - m_use.gather(-1, seg)))
    l = torch.zeros_like(run).scatter_add(-1, seg, p.sum(dim=-1) * w)
    idx = seg[..., None].expand(*seg.shape, Dv)

    def by_segment(weights, values):
        acc_t = torch.einsum("bkrjp,bkjpd->bkrjd", weights, values)
        return torch.zeros_like(acc_t).scatter_add(-2, idx,
                                                   acc_t * w[..., None])

    acc = by_segment(pr, vt)
    top = m.amax(dim=-1, keepdim=True)
    top = torch.where(torch.isinf(top), torch.zeros_like(top), top)
    f = torch.exp(m - top)                          # empty segments: 0
    total = (f * l).sum(dim=-1)[..., None].clamp_min(1e-30)
    out = (f[..., None] * acc).sum(dim=-2) / total
    if flip_rel is None:
        return out, None
    acc_f = by_segment(_rounding_flips(p, pr, cd, flip_rel), vt.abs())
    return out, (f[..., None] * acc_f).sum(dim=-2) / total


def flash_decode_attention_plain(q, new_k, new_v, cache_k, cache_v, lengths,
                                 *, layer=None, k_scale=None, v_scale=None):
    """Plain PyTorch version: the in-place row write at lengths[b], then
    ``attend_plain`` over the row's cached prefix."""
    from compressed_tensors_tpu_torch.models.llama import _quantize_to_cache

    ck, cv = (cache_k[layer], cache_v[layer]) if cache_k.dim() == 5 else (
        cache_k, cache_v)
    nk_c = _quantize_to_cache(new_k, k_scale, ck.dtype, head_axis=1)
    nv_c = _quantize_to_cache(new_v, v_scale, cv.dtype, head_axis=1)
    out = attend_plain(q, nk_c, nv_c, ck, cv, lengths, k_scale, v_scale)
    lengths = lengths.to(torch.int64)
    rows = torch.nonzero((lengths >= 0) & (lengths < ck.shape[2])).reshape(-1)
    byte_view(ck)[rows, :, lengths[rows]] = byte_view(nk_c[rows])
    byte_view(cv)[rows, :, lengths[rows]] = byte_view(nv_c[rows])
    return out, cache_k, cache_v


def flash_decode_attention(q: torch.Tensor, new_k: torch.Tensor,
                           new_v: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, lengths: torch.Tensor, *,
                           layer: int = 0,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None):
    """q (B, H, D), new_k/new_v (B, KVH, D) post-RoPE; cache (L, B, KVH,
    S_pad, D); lengths (B,) int32, negative = inactive. Returns (out (B, H,
    D), cache_k, cache_v), the caches updated in place."""
    if q.device.type == "cpu":
        return flash_decode_attention_plain(
            q, new_k, new_v, cache_k, cache_v, lengths, layer=layer,
            k_scale=k_scale, v_scale=v_scale)
    B, H, D, KVH, rep = check_decode_operands(
        "flash_decode_attention", q, new_k, new_v, cache_k, cache_v, lengths)
    kind, ks, vs, _, scaled = kernel_scales(
        "flash_decode_attention", q, cache_k, k_scale, v_scale)
    if cache_k.dim() != 5 or cache_k.shape[1] != B:
        raise ValueError("flash_decode_attention needs the (L, B, KVH, S_pad, "
                         "D) cache")
    L, _, _, S_pad, _ = cache_k.shape
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for {L} cache layers")
    if S_pad % CHUNK:
        raise ValueError(f"S_pad={S_pad} must be a multiple of the chunk "
                         f"{CHUNK}")
    out = torch.empty_like(q)
    per, splits, (part_ml, part_o, _scratch) = split_scratch(
        B, KVH, rep, D, S_pad, cache_k.element_size(), q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.ct_flash_decode(
            q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
            cache_k.data_ptr(), cache_v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), ks.data_ptr() if scaled else None,
            vs.data_ptr() if scaled else None, part_ml, part_o, B, KVH,
            rep, S_pad, D, layer, kind, per, splits, 1.0 / math.sqrt(D),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_decode_attention")
    if scaled:
        flash_decode_attention.scaled_launches += 1
    else:
        flash_decode_attention.launches += 1
    return out, cache_k, cache_v


flash_decode_attention.launches = 0
flash_decode_attention.scaled_launches = 0
