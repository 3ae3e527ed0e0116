"""Collective-overlapped tensor-parallel matmuls: send/recv rings over a
mesh axis.

Counterpart of ``compressed_tensors_tpu/parallel/overlap.py``, where each
ring step's ``ppermute`` moves the next chunk while the current one is
multiplied. Here the step's exchange is a ``dist.batch_isend_irecv``
(send to rank + 1, receive from rank - 1 along the axis), started before
the step's product and waited for after it, with the JAX package's index
arithmetic: at step i a rank holds the chunk of rank (r - i) mod tp, and
the reduce-scatter accumulator at step i is the partial of output shard
(r - 1 - i) mod tp.

``ring_allgather_matmul_quantized`` runs each chunk through B1
(``ops/kernels/w4a16_matmul.py:w4a16_matmul``, mode ``int4b``; its plain
version for CPU tensors) on static K-slices of the rank's N-shard, cut
once per weight and kept contiguous (``ring_k_slices``). B1 writes its
output in bf16 on the card (the wrapper has no f32 output), so each
chunk's partial is rounded to bf16 once and the partials are summed in
f32.
"""

from __future__ import annotations

import weakref

import torch
import torch.distributed as dist

from compressed_tensors_tpu_torch.ops.kernels.w4a16_matmul import (
    w4a16_matmul,
)
from compressed_tensors_tpu_torch.ops.linear import QuantizedTensor

__all__ = ["ring_allgather_matmul", "matmul_reducescatter",
           "ring_allgather_matmul_fn", "ring_allgather_matmul_quantized",
           "ring_k_slices"]


def _exchange(mesh, send: torch.Tensor, recv: torch.Tensor, axis: str):
    """Start sending ``send`` to the next rank along ``axis`` and receiving
    the previous rank's into ``recv``; returns the work handles."""
    size, r = mesh.shape[axis], mesh.index(axis)
    ranks = mesh.group_ranks[axis]
    group = mesh.group(axis)
    return dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, ranks[(r + 1) % size], group),
        dist.P2POp(dist.irecv, recv, ranks[(r - 1) % size], group)])


def ring_allgather_matmul_fn(x_shard: torch.Tensor, chunk_matmuls, mesh,
                             axis: str = "tp") -> torch.Tensor:
    """Generalized ring: ``chunk_matmuls[src](x_chunk) -> (B, N_local)``
    computes the partial of the x shard owned by rank ``src``; the partials
    are summed in f32 while the chunks travel the ring, and the sum is cast
    to x's dtype."""
    size, r = mesh.shape[axis], mesh.index(axis)
    chunk = x_shard.contiguous()
    acc = None
    for i in range(size):
        src = (r - i) % size
        works = None
        if i < size - 1:
            nxt = torch.empty_like(chunk)
            works = _exchange(mesh, chunk, nxt, axis)
        part = chunk_matmuls[src](chunk).to(torch.float32)
        acc = part if acc is None else acc + part
        if works is not None:
            for w in works:
                w.wait()
            chunk = nxt
    return acc.to(x_shard.dtype)


def ring_allgather_matmul(x_shard: torch.Tensor, w_local: torch.Tensor,
                          mesh, axis: str = "tp") -> torch.Tensor:
    """y_local = allgather(x) @ w_local^T without gathering x: x_shard
    (B, K/tp) is this rank's feature shard, w_local (N/tp, K) its output
    rows; returns (B, N/tp)."""
    size = mesh.shape[axis]
    n_local = w_local.shape[0]
    k_shard = x_shard.shape[1]
    w_slices = w_local.reshape(n_local, size, k_shard)

    def chunk(src):
        w = w_slices[:, src].to(torch.float32)
        return lambda c: c.to(torch.float32) @ w.t()

    return ring_allgather_matmul_fn(x_shard, [chunk(s) for s in range(size)],
                                    mesh, axis)


def matmul_reducescatter(x_full: torch.Tensor, w_kshard: torch.Tensor, mesh,
                         axis: str = "tp") -> torch.Tensor:
    """y_shard = reduce_scatter(x @ w^T): x_full (B, K/tp) and w_kshard
    (N, K/tp) are this rank's contraction shards; returns this rank's
    (B, N/tp) block of the sum over the axis. Each step's partial is
    computed while the accumulator travels to the next rank."""
    size, r = mesh.shape[axis], mesh.index(axis)
    n = w_kshard.shape[0]
    w_out = w_kshard.reshape(size, n // size, -1).to(torch.float32)
    xf = x_full.to(torch.float32)

    def partial(i):
        return xf @ w_out[(r - 1 - i) % size].t()

    acc = partial(0)
    for i in range(1, size):
        recv = torch.empty_like(acc)
        works = _exchange(mesh, acc, recv, axis)
        part = partial(i)
        for w in works:
            w.wait()
        acc = recv + part
    return acc.to(x_full.dtype)


# K-slices of each weight, cut once: id of its kernel_packed tensor ->
# slices, dropped when that tensor is freed (tensors compare elementwise,
# so they cannot key a WeakKeyDictionary)
_RING_SLICES: dict = {}


def ring_k_slices(qt: QuantizedTensor, parts: int) -> list:
    """The ``parts`` K-slices of a W4A16 kernel layout (int4 words (N, K/8)
    with (K/g, N) scales), each whole groups and words, contiguous: a list
    of (words, scales, zero points, k). Cut once per weight."""
    kind, n, k, g = qt.kernel_meta
    if kind != "w4a16" or qt.kernel_perm is not None:
        raise ValueError("the quantized ring takes the int4-word layout "
                         "without an actorder permutation")
    if k % parts or (k // parts) % g or (k // parts) % 8:
        raise ValueError(f"K {k} does not split into {parts} slices of "
                         f"whole groups of {g}")
    key = id(qt.kernel_packed)
    cached = _RING_SLICES.get(key)
    if cached is not None and len(cached) == parts:
        return cached
    ks = k // parts
    out = []
    for s in range(parts):
        zp = qt.kernel_zp
        out.append((
            qt.kernel_packed[:, s * ks // 8:(s + 1) * ks // 8].contiguous(),
            qt.kernel_scales[s * ks // g:(s + 1) * ks // g].contiguous(),
            zp[s * ks // g:(s + 1) * ks // g].contiguous()
            if zp is not None else None, ks))
    if key not in _RING_SLICES:
        weakref.finalize(qt.kernel_packed, _RING_SLICES.pop, key, None)
    _RING_SLICES[key] = out
    return out


def ring_allgather_matmul_quantized(x_shard: torch.Tensor,
                                    qt: QuantizedTensor, mesh,
                                    axis: str = "tp") -> torch.Tensor:
    """The ring whose chunk products are B1 launches on static K-slices of
    the rank's N-shard ``qt`` (a prepared W4A16 layout of shape
    (N/tp, K)); x_shard is (B, K/tp)."""
    slices = ring_k_slices(qt, mesh.shape[axis])
    n, g = qt.kernel_meta[1], qt.kernel_meta[3]

    def chunk(src):
        words, scales, zp, ks = slices[src]
        return lambda c: w4a16_matmul(c, words, scales, zp, n=n, k=ks,
                                      group_size=g, mode="int4b")

    return ring_allgather_matmul_fn(
        x_shard, [chunk(s) for s in range(len(slices))], mesh, axis)
