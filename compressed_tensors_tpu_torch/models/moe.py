"""Mixture-of-Experts layer: top-k routing with sort-based capacity
dispatch, run-compressed expert FFNs.

Counterpart of ``compressed_tensors_tpu/models/moe.py``. Tokens are sorted
by expert id and scattered into an (E, C, H) dispatch buffer, so each of
the expert FFN's three linears is one batched matmul over the expert dim:
one expert-batched kernel launch for the stacked WnA16 layouts
(``quantized_matmul_experts``), never a loop over experts. Slots at or past
an expert's capacity C are dropped, as in the JAX package; padding rows of
the buffer are zeros, computed and never read.

The combine sums each token's k weighted slots in a fixed order (gathered
into (T, k, H), then summed over k), where the JAX package scatter-adds
them: the same sum to an f32 rounding, and the same bits in every run on
the card, where a scatter-add of floats sums in no fixed order.

The router stays dense, in f32, as in the JAX package.

Under data parallelism (``dp_block``) the forward's rows are the rank's
block of the global batch, where the JAX package's GSPMD routes the
global batch: capacity and the kept slots are computed over every
block's top-k experts, gathered over "dp" (a small int tensor, once a
layer), in global row order, and the rank dispatches and computes its
own slots only. A slot's expert products do not depend on the other rows
of the (E, C, H) buffer, so each row comes out as the unsplit batch
would give it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from compressed_tensors_tpu_torch.models.config import LlamaConfig
from compressed_tensors_tpu_torch.ops.linear import (
    quantized_matmul,
    quantized_matmul_experts,
)

__all__ = ["moe_mlp", "moe_capacity", "dispatch_rows"]


def moe_capacity(num_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float = 1.25) -> int:
    """Static per-expert token capacity: ceil(T*k/E * f), rounded up to a
    multiple of 8 (at least 8), and no more than T*k rounded up to 8."""
    c = math.ceil(num_tokens * top_k / num_experts * capacity_factor)
    c = max(8, math.ceil(c / 8) * 8)
    return min(c, max(8, math.ceil(num_tokens * top_k / 8) * 8))


def _route(tokens: torch.Tensor, router_w: torch.Tensor,
           config: LlamaConfig):
    """Top-k routing in f32. Returns (weights (T, k) f32, expert ids (T, k)
    int64)."""
    logits = tokens.to(torch.float32) @ router_w.to(torch.float32).t()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, config.num_experts_per_tok, dim=-1)
    if config.norm_topk_prob:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    return top_w, top_i


def dispatch_rows(top_i: torch.Tensor, num_experts: int, capacity: int):
    """The (token, k) slots of ``top_i`` (T, k) sorted by expert id (stable:
    within an expert, in token order) and each sorted slot's row e * C +
    pos of the (E * C, H) dispatch buffer, pos its place in its expert's
    group; a slot at or past the capacity C gets row E * C (dropped).
    Returns (sort_idx, rows), both (T * k,)."""
    flat_e = top_i.reshape(-1)
    sort_idx = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[sort_idx]
    # a scatter-add count: bincount on the card reads its input's maximum
    # back to the host
    counts = torch.zeros(num_experts, dtype=flat_e.dtype,
                         device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(flat_e.numel(), device=flat_e.device) - starts[e_sorted]
    rows = torch.where(pos < capacity, e_sorted * capacity + pos,
                       num_experts * capacity)
    return sort_idx, rows


def moe_mlp(layer: dict, x: torch.Tensor, config: LlamaConfig,
            capacity_factor: float = 1.25,
            use_kernels: bool = True,
            dp_block: bool = False) -> torch.Tensor:
    """MoE FFN block: route -> dispatch -> expert FFN -> weighted combine.

    ``layer["moe"]`` holds "router", the (E, H) dense router weight;
    "experts", the stacked QuantizedTensors {gate_proj, up_proj,
    down_proj} with a leading expert dim; and optionally "shared_expert",
    {gate,up,down}_proj of an always-on expert (Qwen/DeepSeek), run
    through ``quantized_matmul``. ``use_kernels`` selects the kernel
    layouts (their plain versions on the CPU) or the non-kernel path, for
    the experts and the shared expert alike. ``dp_block``: ``x`` holds
    this rank's dp block of the batch (``parallel.mesh.dp_rows``), and
    capacity is counted over every block's rows; otherwise ``x`` is the
    whole batch and nothing is gathered.
    """
    moe = layer["moe"]
    B, S, H = x.shape
    T = B * S
    E = config.num_local_experts
    k = config.num_experts_per_tok
    tokens = x.reshape(T, H)

    top_w, top_i = _route(tokens, moe["router"], config)
    shard = layer.get("shard")
    first = 0   # this call's first token in the routed batch
    if dp_block:
        if shard is None:
            raise ValueError("dp_block needs params sharded over a dp mesh "
                             "(shard_llama_params)")
        first = shard.mesh.index("dp") * T
        top_i = shard.mesh.all_gather(top_i, "dp", dim=0)
    C = moe_capacity(top_i.shape[0], E, k, capacity_factor)
    sort_idx, rows = dispatch_rows(top_i, E, C)
    # each of this call's (token, k) slots' buffer row, in token order
    slot_rows = torch.empty_like(rows)
    slot_rows[sort_idx] = rows
    slot_rows = slot_rows[first * k:(first + T) * k]
    # dispatch into (E, C, H); dropped slots go to a spare row past the
    # buffer (no host sync on which slots survive)
    buf = torch.zeros((E * C + 1, H), dtype=x.dtype, device=x.device)
    buf[slot_rows] = tokens.repeat_interleave(k, dim=0)
    dispatched = buf[:E * C].view(E, C, H)

    # a rank of an expert-parallel mesh holds experts [e0, e0 + El) (with
    # their tp shards, ``parallel.mesh``) and computes their rows only
    e0, El, ex_tp = (shard.experts if shard is not None
                     and shard.experts is not None else (0, E, False))
    if El != E:
        dispatched = dispatched[e0:e0 + El]
    experts = moe["experts"]
    gate = quantized_matmul_experts(dispatched, experts["gate_proj"],
                                    use_kernels)
    up = quantized_matmul_experts(dispatched, experts["up_proj"], use_kernels)
    if ex_tp:
        # K-sharded down projections: the rank's partials
        from compressed_tensors_tpu_torch.parallel.mesh import (
            row_parallel_experts,
        )

        y = row_parallel_experts(F.silu(gate) * up, experts["down_proj"],
                                 shard.mesh, use_kernels)
    else:
        y = quantized_matmul_experts(F.silu(gate) * up, experts["down_proj"],
                                     use_kernels)  # (El, C, H)
    if El != E:
        full = torch.zeros((E, C, H), dtype=y.dtype, device=y.device)
        full[e0:e0 + El] = y
        y = full

    # combine: each (token, k) slot's expert row (the zero row when
    # dropped), weighted in f32 and summed over the k slots in order
    y = torch.cat([y.reshape(E * C, H),
                   torch.zeros((1, H), dtype=y.dtype, device=y.device)])
    contrib = y[slot_rows].to(torch.float32) * top_w.reshape(T * k, 1)
    out = contrib.reshape(T, k, H).sum(dim=1)
    if shard is not None and shard.experts is not None:
        # the other experts' rows (where the rank holds some of them only:
        # an expert count that "ep" does not divide replicates them), then
        # the other tp shards' partials
        if El != E:
            shard.mesh.all_reduce(out, "ep")
        if ex_tp:
            shard.mesh.all_reduce(out, "tp")
    out = out.to(x.dtype)

    shared = moe.get("shared_expert")
    if shared is not None:
        g = quantized_matmul(tokens, shared["gate_proj"], use_kernels)
        u = quantized_matmul(tokens, shared["up_proj"], use_kernels)
        if shard is not None and shard.shared_rows:
            from compressed_tensors_tpu_torch.parallel.mesh import (
                row_parallel_matmul,
            )

            down = row_parallel_matmul(F.silu(g) * u, shared["down_proj"],
                                       shard.mesh, use_kernels=use_kernels)
        else:
            down = quantized_matmul(F.silu(g) * u, shared["down_proj"],
                                    use_kernels)
        out = out + down
    return out.reshape(B, S, H)
