"""One decode step of GQA attention on the stacked KV cache.

Replaces ``compressed_tensors_tpu/ops/kernels/decode_attention.py:
decode_attention`` with the hand-written Hopper kernel in
``csrc/decode_attention.cu``: one block per (kv head, batch row) writes the
step's K/V row in place at ``lengths[b]`` (rows with a negative length are
left untouched), then attends the group's query heads over positions
0..lengths[b] in f32, with the normalized probabilities rounded to q's
dtype before P.V as in the TPU kernel. The cache is (L, B, KVH, S_pad, D):
no lane padding of D and no head packing, which the TPU layout needed for
Mosaic's (8, 128) tiles.

The cache tensors are updated in place, by the kernel and by the plain
version alike; the function returns them for the JAX package's (out,
cache_k, cache_v) contract.

Bound on the H100: the bytes of the cache prefix each row reads,
2 * B*KVH*(len+1)*D*2 per step and layer, against 3.35 TB/s. The model
runs it for caches with S_pad < 512 under ``decode_attn="auto"``, as the
JAX package does; ``flash_decode.py`` serves the larger ones.

``decode_attention`` launches the kernel for CUDA tensors and uses
``decode_attention_plain`` only for CPU tensors. Quantized (fp8/int8)
caches with k/v scales have no CUDA kernel yet (ROADMAP A8).
"""

from __future__ import annotations

import math

import torch

from compressed_tensors_tpu_torch.ops.kernels import _build

__all__ = ["decode_attention", "decode_attention_plain"]


def _layer_views(cache_k, cache_v, layer):
    if cache_k.dim() == 5:
        if layer is None:
            raise ValueError("a stacked (L, B, KVH, S_pad, D) cache needs "
                             "the layer index")
        return cache_k[layer], cache_v[layer]
    return cache_k, cache_v


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
    for t in (q, new_k, new_v, cache_k, cache_v):
        if (t.dtype != torch.bfloat16 or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} operands must be contiguous bf16 on "
                             "one device")
    if (lengths.dtype != torch.int32 or lengths.device != q.device
            or tuple(lengths.shape) != (B,)):
        raise ValueError("lengths must be (B,) int32 on q's device")
    return B, H, D, KVH, rep


def decode_attention_plain(q, new_k, new_v, cache_k, cache_v, lengths, *,
                           layer=None, k_scale=None, v_scale=None):
    """Plain PyTorch version: in-place row write, then masked softmax
    attention in f32 with probabilities cast to q's dtype before P.V (the
    TPU kernel's numerics). Outputs of inactive rows are zero."""
    from compressed_tensors_tpu_torch.models.llama import (
        _dequantize_from_cache,
        _quantize_to_cache,
    )

    ck, cv = _layer_views(cache_k, cache_v, layer)
    B, H, D = q.shape
    KVH, S_pad = ck.shape[1], ck.shape[2]
    rep = H // KVH
    lengths = lengths.to(torch.int64)
    rows = torch.nonzero((lengths >= 0) & (lengths < S_pad)).reshape(-1)
    ck[rows, :, lengths[rows]] = _quantize_to_cache(
        new_k[rows], k_scale, ck.dtype, head_axis=1)
    cv[rows, :, lengths[rows]] = _quantize_to_cache(
        new_v[rows], v_scale, cv.dtype, head_axis=1)

    keys = _dequantize_from_cache(ck, k_scale, q.dtype).to(torch.float32)
    values = _dequantize_from_cache(cv, v_scale, q.dtype).to(torch.float32)
    qg = q.reshape(B, KVH, rep, D).to(torch.float32)
    scores = torch.einsum("bkrd,bksd->bkrs", qg, keys) * (1.0 / math.sqrt(D))
    pos = torch.arange(S_pad, device=q.device)
    mask = pos[None, :] <= lengths[:, None]                  # (B, S_pad)
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype).to(torch.float32)
    out = torch.einsum("bkrs,bksd->bkrd", probs, values).reshape(B, H, D)
    out = torch.where((lengths >= 0)[:, None, None], out,
                      torch.zeros_like(out))
    return out.to(q.dtype), cache_k, cache_v


def decode_attention(q: torch.Tensor, new_k: torch.Tensor,
                     new_v: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, lengths: torch.Tensor, *,
                     layer: int | None = None,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None):
    """q (B, H, D), new_k/new_v (B, KVH, D) post-RoPE; cache (L, B, KVH,
    S_pad, D) with ``layer``, or (B, KVH, S_pad, D); lengths (B,) int32,
    negative = inactive. Returns (out (B, H, D), cache_k, cache_v), the
    caches being the same tensors, updated in place."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, new_k, new_v, cache_k, cache_v,
                                      lengths, layer=layer, k_scale=k_scale,
                                      v_scale=v_scale)
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "decode_attention on a quantized cache (k/v scales) has no CUDA "
            "kernel yet (ROADMAP A8)")
    B, H, D, KVH, rep = check_decode_operands(
        "decode_attention", q, new_k, new_v, cache_k, cache_v, lengths)
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
            out.data_ptr(), B, KVH, rep, S_pad, D, layer,
            1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out, cache_k, cache_v


decode_attention.launches = 0
