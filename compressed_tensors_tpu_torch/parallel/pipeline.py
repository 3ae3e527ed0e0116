"""Pipeline parallelism: GPipe-style microbatched inference over the "pp"
mesh axis.

Counterpart of ``compressed_tensors_tpu/parallel/pipeline.py``. The layers
are grouped into contiguous stages (``stack_stage_params``: per-stage lists
of layers, where the JAX package stacks each stage's arrays); stage s runs
microbatch t - s at step t, activations move to the next stage by
send/recv over the pp group, and the last stage's output is broadcast to
every pp rank before the final norm and the lm_head. In a pp x tp mesh a
stage's layers are tp-sharded (``shard_llama_params``) and their
collectives run inside the stage. In a pp x dp mesh each rank passes its
dp block of the rows (``parallel.mesh.dp_rows``) and pipelines them over
its own pp line (``group_ranks["pp"]`` of its dp index); a MoE stage
counts capacity over those rows. Send/recv need a backend that carries
the tensors' device (gloo refuses CUDA tensors).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from compressed_tensors_tpu_torch.models.config import LlamaConfig
from compressed_tensors_tpu_torch.models.llama import (
    _attention,
    _embed,
    _lm_head,
    _mlp,
    _rope,
    init_kv_cache,
    rms_norm,
)

__all__ = ["stack_stage_params", "pipeline_forward"]


def stack_stage_params(layers: list, n_stages: int) -> list:
    """Group ``layers`` into ``n_stages`` contiguous stages of equal length
    (a list of layer lists; mixed schemes need no bucketing)."""
    L = len(layers)
    if L % n_stages != 0:
        raise ValueError(f"{L} layers not divisible into {n_stages} stages")
    lps = L // n_stages
    return [list(layers[s * lps:(s + 1) * lps]) for s in range(n_stages)]


def _stage_forward(layers: list, x, positions, config: LlamaConfig,
                   use_kernels: bool):
    """One stage's layers on one microbatch, over fresh local KV buffers
    (prefill semantics)."""
    B, S, _ = x.shape
    cos, sin = _rope(positions, config.head_dim, config.rope_theta)
    cache = init_kv_cache(
        dataclasses.replace(config, num_hidden_layers=len(layers)), B, S,
        dtype=x.dtype, device=x.device)
    kv_k, kv_v = cache.k, cache.v
    for j, layer in enumerate(layers):
        h = rms_norm(x, layer["input_layernorm"], config.rms_norm_eps)
        attn, kv_k, kv_v = _attention(layer, j, h, cos, sin, kv_k, kv_v,
                                      cache.lengths, config, positions,
                                      fresh_prefill=True,
                                      use_kernels=use_kernels)
        x = x + attn
        h = rms_norm(x, layer["post_attention_layernorm"],
                     config.rms_norm_eps)
        x = x + _mlp(layer, h, config, use_kernels)
    return x


def pipeline_forward(params: dict, config: LlamaConfig,
                     input_ids: torch.Tensor, positions: torch.Tensor, mesh,
                     n_microbatches: int | None = None,
                     use_kernels: bool = True) -> torch.Tensor:
    """Full forward with the decoder trunk pipelined over mesh axis "pp";
    returns the logits (B, S, V) on every rank.

    ``params`` holds "stages" from ``stack_stage_params`` (this rank runs
    ``stages[pp index]``; the others' entries may be None) plus the usual
    embed/norm/lm_head. The batch must divide into ``n_microbatches``
    (default: the pp size).
    """
    n_stages = mesh.shape["pp"]
    M = n_microbatches or max(n_stages, 1)
    B, S = input_ids.shape
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible into {M} microbatches")
    mb = B // M
    shard = params.get("shard")
    if shard is not None:
        shard.mesh.require_groups()
        config = shard.local_config(config)
    if n_stages > 1:
        mesh.group("pp")
    s = mesh.index("pp")
    layers = params["stages"][s]
    ranks = mesh.group_ranks["pp"]

    x = _embed(params, input_ids)  # (B, S, H)
    H = x.shape[-1]
    x_mbs = x.reshape(M, mb, S, H)
    pos_mbs = positions.reshape(M, mb, S)
    outputs = torch.zeros((M, mb, S, H), dtype=x.dtype, device=x.device)
    sends = []
    for t in range(M + n_stages - 1):
        m = t - s   # stage s runs microbatch t - s at step t
        if not 0 <= m < M:
            continue
        if s == 0:
            inp = x_mbs[m]
        else:
            inp = torch.empty((mb, S, H), dtype=x.dtype, device=x.device)
            dist.recv(inp, ranks[s - 1], group=mesh.group("pp"))
        out = _stage_forward(layers, inp, pos_mbs[m], config, use_kernels)
        if s < n_stages - 1:
            sends.append(dist.isend(out.contiguous(), ranks[s + 1],
                                    group=mesh.group("pp")))
        else:
            outputs[m] = out
    for w in sends:
        w.wait()
    if n_stages > 1:
        # replicate the last stage's outputs to every pp rank
        dist.broadcast(outputs, ranks[-1], group=mesh.group("pp"))
    return _lm_head(params, outputs.reshape(B, S, H), config, use_kernels)
