"""Causal GQA flash attention over a fresh prompt.

Replaces ``compressed_tensors_tpu/ops/kernels/prefill_attention.py:
prefill_attention`` with the hand-written Hopper kernel in
``csrc/prefill_attention.cu``: FlashAttention-2 on bf16 tensor cores
(``mma.sync``), one block of 4 warps per 64 folded query rows (the group's
query heads folded position-major into the rows) and kv head, K/V in
64-key tiles double-buffered in shared memory, the online softmax on the
score fragments, causal tiles skipped, and the S x S scores never written
to device memory.

Bound on the H100: 4*B*H*(S(S+1)/2)*D operations on bf16 inputs (the
causal half of QK^T and P.V); at S = 128 to 512 the q/k/v/out bytes are of
the same order.

``prefill_attention`` launches the kernel for CUDA tensors and uses
``prefill_attention_plain`` only for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from compressed_tensors_tpu_torch.ops.kernels import _build

__all__ = ["prefill_attention", "prefill_attention_plain"]


def prefill_attention_plain(q, k, v, *, sm_scale=None):
    """Plain PyTorch version with the TPU kernel's numerics: q scaled by
    1/sqrt(D) in its own dtype, f32 scores and softmax, probabilities cast
    to v's dtype before P.V with f32 accumulation."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    rep = H // KVH
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    qs = (q * torch.tensor(sm_scale, dtype=q.dtype)).to(torch.float32)
    qs = qs.reshape(B, S, KVH, rep, D)
    scores = torch.einsum("bskrd,btkd->bkrst", qs, k.to(torch.float32))
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bkrst,btkd->bskrd", p.to(v.dtype).to(torch.float32),
                      v.to(torch.float32))
    out = pv / l.permute(0, 3, 1, 2, 4)
    return out.reshape(B, S, H, D).to(q.dtype)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      sm_scale: float | None = None) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, S, KVH, D) post-RoPE; returns (B, S, H, D)
    in q's dtype."""
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k, v, sm_scale=sm_scale)
    B, S, H, D = q.shape
    KVH = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if D not in (64, 128) or H % KVH:
        raise NotImplementedError(
            f"prefill_attention kernel serves D in (64, 128) and H a "
            f"multiple of KVH, got D={D}, H={H}, KVH={KVH}")
    for t in (q, k, v):
        if (t.dtype != torch.bfloat16 or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError("prefill_attention operands must be contiguous "
                             "bf16 on one device")
    if tuple(k.shape) != (B, S, KVH, D) or v.shape != k.shape:
        raise ValueError("prefill_attention k/v shape mismatch")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.ct_prefill_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, KVH, D, float(sm_scale),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "prefill_attention")
    prefill_attention.launches += 1
    return out


prefill_attention.launches = 0
