"""Attention and KV-cache quantization: state, hooks and calibration.

Counterpart of ``compressed_tensors_tpu/modeling/attention.py``: a state
object with the q/k/v scales (the ``q_scale``/``k_scale``/``v_scale``
tensors a checkpoint carries on its attention modules), hook registries
over post-RoPE queries and pre-cache keys/values, the fake quantization
at those points, and min-max calibration of the scales. Tensors are in
the (B, S, H, D) layout; ``calibrate_kv_scales`` also takes each row's
length, so that rows read from a padded cache (the engine's
(L, B, KVH, S_pad, D) cache, transposed) count only the positions they
hold.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from compressed_tensors_tpu_torch.ops.qparams import calculate_qparams
from compressed_tensors_tpu_torch.quantization.quant_args import (
    QuantizationArgs,
)
from compressed_tensors_tpu_torch.quantization.quant_scheme import (
    QuantizationScheme,
)

__all__ = [
    "AttentionQuantState",
    "validate_attention_scheme",
    "initialize_hooked_attention",
    "initialize_hooked_kv_cache",
    "quantize_post_rope",
    "calibrate_kv_scales",
    "register_query_hook",
    "register_key_hook",
    "register_value_hook",
]

Hook = Callable[[torch.Tensor], Optional[torch.Tensor]]


@dataclasses.dataclass
class AttentionQuantState:
    """Per-attention-module quantization state (q/k/v scales + scheme)."""

    scheme: QuantizationScheme | None = None
    q_scale: torch.Tensor | None = None
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None
    query_hooks: list = dataclasses.field(default_factory=list)
    key_hooks: list = dataclasses.field(default_factory=list)
    value_hooks: list = dataclasses.field(default_factory=list)

    @property
    def args(self) -> QuantizationArgs | None:
        return self.scheme.input_activations if self.scheme else None


def validate_attention_scheme(scheme: QuantizationScheme) -> None:
    """Attention schemes may only quantize activations (q/k/v states)."""
    if scheme.weights is not None:
        raise ValueError(
            "Cannot apply weight quantization to attention. Instead, "
            "target the (q|k|v)_proj submodule layers of attention")
    if scheme.input_activations is None:
        raise ValueError("Cannot apply attention quantization without "
                         "specifying input activations")
    if scheme.output_activations is not None:
        raise ValueError("Cannot apply output quantization to attention")


def initialize_hooked_attention(
    kv_cache_scheme: QuantizationArgs | None = None,
    quantize_query: bool = False,
    num_heads: int | None = None,
    num_kv_heads: int | None = None,
    head_dim: int | None = None,
    device: str | torch.device = "cuda",
) -> AttentionQuantState:
    """Attention quant state with unit q/k/v scales: (1,) per tensor, or
    head-shaped for the ``attn_head`` strategy (q (num_heads, 1, 1), k/v
    (num_kv_heads, 1, 1))."""
    scheme = None
    if kv_cache_scheme is not None:
        scheme = QuantizationScheme(targets=["re:.*self_attn$"],
                                    input_activations=kv_cache_scheme)
        validate_attention_scheme(scheme)
    state = AttentionQuantState(scheme=scheme)
    if kv_cache_scheme is not None:
        per_head = kv_cache_scheme.strategy == "attn_head"
        if per_head and (num_heads is None or num_kv_heads is None):
            raise ValueError("attn_head strategy requires "
                             "num_heads/num_kv_heads")

        def _ones(h):
            return torch.ones((h, 1, 1) if per_head else (1,),
                              dtype=torch.float32, device=device)

        state.k_scale = _ones(num_kv_heads)
        state.v_scale = _ones(num_kv_heads)
        if quantize_query:
            state.q_scale = _ones(num_heads)
    return state


def initialize_hooked_kv_cache(
    kv_cache_scheme: QuantizationArgs,
    device: str | torch.device = "cuda",
) -> AttentionQuantState:
    """The state of ``initialize_hooked_attention`` without the query."""
    return initialize_hooked_attention(kv_cache_scheme, quantize_query=False,
                                       device=device)


def register_query_hook(state: AttentionQuantState, hook: Hook) -> None:
    """Hook over post-RoPE queries."""
    state.query_hooks.append(hook)


def register_key_hook(state: AttentionQuantState, hook: Hook) -> None:
    """Hook over pre-cache keys."""
    state.key_hooks.append(hook)


def register_value_hook(state: AttentionQuantState, hook: Hook) -> None:
    """Hook over pre-cache values."""
    state.value_hooks.append(hook)


def _apply_hooks(hooks: list, value: torch.Tensor) -> torch.Tensor:
    for hook in hooks:
        out = hook(value)
        if out is not None:
            value = out
    return value


def quantize_post_rope(
    state: AttentionQuantState,
    query: torch.Tensor | None = None,
    key: torch.Tensor | None = None,
    value: torch.Tensor | None = None,
):
    """Run the hooks, then fake-quantize, at the hook points: the post-RoPE
    query and the pre-cache key and value ((B, S, H, D)). Returns the
    three tensors (None stays None)."""
    from compressed_tensors_tpu_torch.ops.quantize import fake_quantize

    args = state.args

    def _fq(v, scale):
        if v is None:
            return None
        if args is None or scale is None:
            return v
        if scale.numel() > 1:
            # head-shaped (H, 1, 1) scales over (B, S, H, D)
            scale = scale.reshape(-1, 1)
        return fake_quantize(v, scale, None, args).to(v.dtype)

    if query is not None:
        query = _fq(_apply_hooks(state.query_hooks, query), state.q_scale)
    if key is not None:
        key = _fq(_apply_hooks(state.key_hooks, key), state.k_scale)
    if value is not None:
        value = _fq(_apply_hooks(state.value_hooks, value), state.v_scale)
    return query, key, value


def calibrate_kv_scales(
    state: AttentionQuantState,
    keys: torch.Tensor,
    values: torch.Tensor,
    queries: torch.Tensor | None = None,
    lengths: torch.Tensor | None = None,
) -> AttentionQuantState:
    """Min-max calibration of the k/v (and optionally q) scales from
    observed post-RoPE (B, S, H, D) tensors. Per-tensor strategies reduce
    over everything, ``attn_head`` per head ((H, 1, 1) scales). With
    ``lengths`` (B,) only the positions below each row's length count:
    padding would not move an absmax, but it would move an asymmetric
    minimum."""
    args = state.args
    if args is None:
        return state
    per_head = args.strategy == "attn_head"

    def _scale(v):
        lo, hi = v, v
        if lengths is not None:
            held = (torch.arange(v.shape[1], device=v.device)[None, :]
                    < lengths.to(v.device)[:, None])[:, :, None, None]
            lo = torch.where(held, v, torch.full_like(v, float("inf")))
            hi = torch.where(held, v, torch.full_like(v, float("-inf")))
        if per_head:
            scale, _ = calculate_qparams(lo.amin(dim=(0, 1, 3)),
                                         hi.amax(dim=(0, 1, 3)), args)
            return scale.reshape(-1, 1, 1).to(torch.float32)
        scale, _ = calculate_qparams(lo.min(), hi.max(), args)
        return scale.to(torch.float32)

    state.k_scale = _scale(keys)
    state.v_scale = _scale(values)
    if queries is not None and state.q_scale is not None:
        state.q_scale = _scale(queries)
    return state
