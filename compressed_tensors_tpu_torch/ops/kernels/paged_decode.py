"""Decode attention over the paged KV pool.

Replaces ``compressed_tensors_tpu/ops/kernels/paged_decode.py:
paged_decode_attention`` with the hand-written Hopper kernel in
``csrc/paged_decode.cu`` (entry point ``ct_paged_decode``): the flash
decode kernel's split body (``flash_decode.py``) with one indirection,
position p of row b being offset p % page of pool page
``tables[b, p // page]``.
The pool is (L, NP, KVH, page, D): no lane padding, no head packing. Page 0
is the null page that unallocated table entries point at. A row with a
negative length is inactive: its output is zero and the kernel reads and
writes no pool byte for it, not even page 0. The caller guarantees that
``tables[b, lengths[b] // page]`` is a real page for every active row.

The pools are updated in place and returned for the JAX package's (out,
pool_k, pool_v) contract.

Pools of fp8 e4m3 or int8 with per-tensor k/v scales take the flash
decode kernel's scaled arithmetic.

Bound on the H100: the live cache bytes, 2 * sum(len + 1) * KVH * D *
itemsize per layer, against 3.35 TB/s.

``paged_decode_attention`` launches the kernel for CUDA tensors and uses
``paged_decode_attention_plain`` only for CPU tensors. Launches on a bf16
pool count in ``paged_decode_attention.launches``, on an fp8 or int8 pool
in ``paged_decode_attention.scaled_launches``.

MLA's latent head (``decode_attention.is_latent_head``: one kv head, K
rows wider than V rows) takes the latent-head kernel B7-L instead
(``csrc/mla_decode.cu``, entry point ``ct_latent_paged_decode``, the
B5-L body with the page indirection: a 16-position tile lies in one page,
so the page size is a multiple of 16), with the softmax scale
1/sqrt(``true_d``); its launches count in
``paged_decode_attention.latent_launches``.
"""

from __future__ import annotations

import math

import torch

from compressed_tensors_tpu_torch.ops.kernels import _build
from compressed_tensors_tpu_torch.utils.dtypes import byte_view
from compressed_tensors_tpu_torch.ops.kernels.decode_attention import (
    LATENT_TILE,
    check_decode_operands,
    check_latent_operands,
    is_latent_head,
    kernel_scales,
    latent_ranges,
    latent_scratch,
    latent_segments,
)
from compressed_tensors_tpu_torch.ops.kernels.flash_decode import (
    attend_plain,
    split_scratch,
)

__all__ = ["paged_decode_attention", "paged_decode_attention_plain"]


def paged_decode_attention_plain(q, new_k, new_v, pool_k, pool_v, tables,
                                 lengths, *, layer=0, k_scale=None,
                                 v_scale=None, true_d=None,
                                 kernel_order=False, out_dtype=None,
                                 flip_rel=None, ranges=None):
    """Plain PyTorch version: gather each row's pages into a contiguous
    view, ``attend_plain`` over its cached prefix, then write the new row
    into page tables[b, len // page] at offset len % page. It is B7's and
    B7-L's: K and V rows may differ in width (MLA's latent head), and
    ``true_d`` sets the softmax scale 1/sqrt(true_d) (the K width by
    default). ``kernel_order`` sums in B7-L's order over ``ranges``
    (``decode_attention.latent_decode_attention_plain``), ``out_dtype``
    keeps the output unrounded, and ``flip_rel`` makes the first item
    (output, flip) as there."""
    from compressed_tensors_tpu_torch.models.llama import _quantize_to_cache

    pk, pv = pool_k[layer], pool_v[layer]          # (NP, KVH, page, D)
    B, P = tables.shape
    _, KVH, page, _ = pk.shape
    idx = tables.to(torch.int64)

    def gather(pool):
        return byte_view(pool)[idx].permute(0, 2, 1, 3, 4).reshape(
            B, KVH, P * page, pool.shape[-1]).view(pool.dtype)

    nk_c = _quantize_to_cache(new_k, k_scale, pk.dtype, head_axis=1)
    nv_c = _quantize_to_cache(new_v, v_scale, pv.dtype, head_axis=1)
    segments = None
    if kernel_order:
        segments = latent_segments(
            lengths, P * page, ranges or latent_ranges(q.shape[1], q.device))
    out = attend_plain(
        q, nk_c, nv_c, gather(pk), gather(pv), lengths, k_scale, v_scale,
        tile=LATENT_TILE if kernel_order else None, segments=segments,
        inv_sqrt_d=1.0 / math.sqrt(true_d or q.shape[-1]),
        out_dtype=out_dtype, flip_rel=flip_rel)
    lengths = lengths.to(torch.int64)
    rows = torch.nonzero((lengths >= 0) & (lengths < P * page)).reshape(-1)
    pids = idx[rows, lengths[rows] // page]
    offs = lengths[rows] % page
    byte_view(pk)[pids, :, offs] = byte_view(nk_c[rows])
    byte_view(pv)[pids, :, offs] = byte_view(nv_c[rows])
    return out, pool_k, pool_v


def paged_decode_attention(q: torch.Tensor, new_k: torch.Tensor,
                           new_v: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor, *, layer: int = 0,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None,
                           true_d: int | None = None):
    """q (B, H, D), new_k/new_v (B, KVH, D) post-RoPE; pools (L, NP, KVH,
    page, D); tables (B, P) int32 page ids; lengths (B,) int32, negative =
    inactive. Returns (out (B, H, D), pool_k, pool_v), the pools updated in
    place. ``true_d`` sets the softmax scale 1/sqrt(true_d) (D by
    default). MLA's latent head (KVH 1, new_v and the V pool of width Dv)
    gives out (B, H, Dv) through B7-L."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, new_k, new_v, pool_k, pool_v, tables, lengths, layer=layer,
            k_scale=k_scale, v_scale=v_scale, true_d=true_d)
    if pool_k.dim() != 5:
        raise ValueError("paged_decode_attention needs the (L, NP, KVH, page, "
                         "D) pool")
    if (tables.dtype != torch.int32 or tables.device != q.device
            or tables.dim() != 2 or tables.shape[0] != q.shape[0]
            or not tables.is_contiguous()):
        raise ValueError("tables must be (B, P) contiguous int32 on q's device")
    if is_latent_head(new_k, new_v):
        return _latent_paged_decode(q, new_k, new_v, pool_k, pool_v, tables,
                                    lengths, layer, k_scale, v_scale, true_d)
    B, H, D, KVH, rep = check_decode_operands(
        "paged_decode_attention", q, new_k, new_v, pool_k, pool_v, lengths)
    kind, ks, vs, _, scaled = kernel_scales(
        "paged_decode_attention", q, pool_k, k_scale, v_scale)
    L, NP, _, page, _ = pool_k.shape
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for {L} pool layers")
    if page % 16:
        raise ValueError(f"page size {page} must be a multiple of 16")
    out = torch.empty_like(q)
    per, splits, (part_ml, part_o, _scratch) = split_scratch(
        B, KVH, rep, D, tables.shape[1] * page, pool_k.element_size(),
        q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.ct_paged_decode(
            q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
            pool_k.data_ptr(), pool_v.data_ptr(), tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            ks.data_ptr() if scaled else None,
            vs.data_ptr() if scaled else None, part_ml, part_o, B, KVH,
            rep, NP, tables.shape[1], page, D, layer, kind, per, splits,
            1.0 / math.sqrt(true_d or D),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "paged_decode_attention")
    if scaled:
        paged_decode_attention.scaled_launches += 1
    else:
        paged_decode_attention.launches += 1
    return out, pool_k, pool_v


def _latent_paged_decode(q, new_k, new_v, pool_k, pool_v, tables, lengths,
                         layer, k_scale, v_scale, true_d, ranges=None):
    """B7-L on CUDA tensors: one call of ``ct_latent_paged_decode`` (the
    kernel and its merge pass) over ``ranges`` ranges (``latent_ranges``
    of the head count by default)."""
    B, H, Dk, Dv = check_latent_operands(
        "paged_decode_attention", q, new_k, new_v, pool_k, pool_v, lengths)
    kind, ks, vs, _, scaled = kernel_scales(
        "paged_decode_attention", q, pool_k, k_scale, v_scale)
    L, NP, _, page, _ = pool_k.shape
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for {L} pool layers")
    if page % LATENT_TILE:
        raise ValueError(f"page size {page} must be a multiple of "
                         f"{LATENT_TILE}")
    ranges = ranges or latent_ranges(H, q.device)
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
    part, part_ml, prefix = latent_scratch(B, H, Dv, ranges, q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.ct_latent_paged_decode(
            q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
            pool_k.data_ptr(), pool_v.data_ptr(), tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            ks.data_ptr() if scaled else None,
            vs.data_ptr() if scaled else None, part_ml, part.data_ptr(),
            prefix.data_ptr(), B, H, NP, tables.shape[1], page, Dk, Dv,
            layer, L, kind, ranges, 1.0 / math.sqrt(true_d or Dk),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "paged_decode_attention (latent head)")
    paged_decode_attention.latent_launches += 1
    return out, pool_k, pool_v


paged_decode_attention.launches = 0
paged_decode_attention.scaled_launches = 0
paged_decode_attention.latent_launches = 0
