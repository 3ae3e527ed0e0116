"""Llama-family forward pass over compressed-tensors checkpoints run
compressed, in PyTorch.

Counterpart of ``compressed_tensors_tpu/models/llama.py`` for the dense
KV cache, non-MoE, non-MLA path. Every linear is a ``QuantizedTensor``
through ``quantized_matmul``, so weights stay compressed on the device.
The KV cache is (L, B, KVH, S_pad, D) in the cache dtype -- no lane padding
of D and no head packing -- and is updated in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from compressed_tensors_tpu_torch.models.config import LlamaConfig
from compressed_tensors_tpu_torch.ops.kernels.decode_attention import (
    decode_attention,
)
from compressed_tensors_tpu_torch.ops.kernels.prefill_attention import (
    prefill_attention,
)
from compressed_tensors_tpu_torch.ops.linear import (
    QuantizedTensor,
    from_compressed_state,
    materialize_weight,
    prepare_for_kernels,
    quantized_matmul,
)

__all__ = [
    "LlamaConfig",
    "KVCache",
    "init_kv_cache",
    "llama_forward",
    "load_llama_params",
    "resolve_device",
]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another; asking for CUDA without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return device


@dataclasses.dataclass
class KVCache:
    """Dense KV cache with per-slot lengths (every batch row is an
    independent sequence slot). k/v: (L, B, KVH, S_pad, D)."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor  # (B,) int32: valid prefix length per slot


def init_kv_cache(config: LlamaConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, cache_dtype=None,
                  device="cuda") -> KVCache:
    """Zeroed cache with S_pad = max_len rounded up to a multiple of 64."""
    device = resolve_device(device)
    s_pad = -(-max_len // 64) * 64
    shape = (config.num_hidden_layers, batch, config.num_key_value_heads,
             s_pad, config.head_dim)
    cd = cache_dtype or dtype
    return KVCache(
        k=torch.zeros(shape, dtype=cd, device=device),
        v=torch.zeros(shape, dtype=cd, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * weight.to(torch.float32)).to(x.dtype)


def _rope(positions: torch.Tensor, head_dim: int, theta: float):
    """Rotary embeddings (half-rotation layout, HF llama convention)."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim))
    freqs = positions[..., None].to(torch.float32) * inv_freq  # (B, S, D/2)
    return torch.cos(freqs), torch.sin(freqs)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    # x: (B, S, H, D); cos/sin: (B, S, D/2)
    d = x.shape[-1] // 2
    x1, x2 = x[..., :d], x[..., d:]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _cache_scale(scale, x_ndim, head_axis):
    """Broadcastable view of a cache scale: per-tensor, or per-head
    (attn_head, serialized (KVH, 1, 1)) on the kv-head axis."""
    if scale.numel() == 1:
        return scale.reshape(()).to(torch.float32)
    shape = [1] * x_ndim
    shape[head_axis] = scale.numel()
    return scale.reshape(shape).to(torch.float32)


def _quantize_to_cache(x, scale, cache_dtype, head_axis=2):
    """Quantize post-RoPE K/V into the cache representation with the
    serialized k_scale/v_scale (fp8 or int8 caches)."""
    if scale is None or cache_dtype == x.dtype:
        return x.to(cache_dtype)
    scaled = x.to(torch.float32) / _cache_scale(scale, x.ndim, head_axis)
    if cache_dtype.is_floating_point:
        return scaled.to(cache_dtype)
    return torch.round(scaled).clamp(-128, 127).to(cache_dtype)


def _dequantize_from_cache(x, scale, dtype, head_axis=1):
    """Inverse of _quantize_to_cache; cache views are (B, KVH, T, D)."""
    if scale is None or x.dtype == dtype:
        return x.to(dtype)
    return (x.to(torch.float32) * _cache_scale(scale, x.ndim, head_axis)).to(
        dtype)


def _attention(layer: dict, layer_idx: int, x, cos, sin, kv_k_all, kv_v_all,
               cache_lens, config: LlamaConfig, positions,
               fresh_prefill: bool = False, use_kernels: bool = True):
    B, S, _ = x.shape
    H, KVH, D = (config.num_attention_heads, config.num_key_value_heads,
                 config.head_dim)
    if "qkv_proj" in layer:
        qkv = quantized_matmul(x, layer["qkv_proj"], use_kernels)
        s1, s2 = layer["qkv_splits"]
        q = qkv[..., :s1].reshape(B, S, H, D)
        k = qkv[..., s1:s2].reshape(B, S, KVH, D)
        v = qkv[..., s2:].reshape(B, S, KVH, D)
    else:
        q = quantized_matmul(x, layer["q_proj"], use_kernels).reshape(B, S, H, D)
        k = quantized_matmul(x, layer["k_proj"], use_kernels).reshape(B, S, KVH, D)
        v = quantized_matmul(x, layer["v_proj"], use_kernels).reshape(B, S, KVH, D)
    q = _apply_rope(q, cos, sin)
    k = _apply_rope(k, cos, sin)

    k_scale, v_scale = layer.get("k_scale"), layer.get("v_scale")
    if S == 1 and use_kernels and (k_scale is None) == (v_scale is None):
        from compressed_tensors_tpu_torch.flags import FLAGS

        if FLAGS.decode_attn == "flash" and x.is_cuda:
            raise NotImplementedError(
                "decode_attn='flash' has no CUDA kernel yet (ROADMAP B6: "
                "flash_decode_attention); 'auto' runs decode_attention")
        out, kv_k_all, kv_v_all = decode_attention(
            q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous(),
            kv_k_all, kv_v_all, cache_lens, layer=layer_idx,
            k_scale=k_scale, v_scale=v_scale)
        out = out.reshape(B, S, H * D).to(x.dtype)
        return quantized_matmul(out, layer["o_proj"], use_kernels), kv_k_all, kv_v_all

    out = _attention_dense_tail(
        layer, x, q, k, v, kv_k_all[layer_idx], kv_v_all[layer_idx],
        cache_lens, config, positions, fresh_prefill, k_scale, v_scale,
        use_kernels)
    return out, kv_k_all, kv_v_all


def _attention_dense_tail(layer: dict, x, q, k, v, cache_k_l, cache_v_l,
                          cache_lens, config: LlamaConfig, positions,
                          fresh_prefill: bool, k_scale, v_scale,
                          use_kernels: bool = True):
    """K/V write into this layer's (B, KVH, T, D) cache view (in place)
    plus attention. Rows with a negative length are inactive: their cache
    rows are left untouched."""
    B, S, H, D = q.shape
    KVH = config.num_key_value_heads
    cache_dtype = cache_k_l.dtype
    T = cache_k_l.shape[2]
    k_q = _quantize_to_cache(k, k_scale, cache_dtype)
    v_q = _quantize_to_cache(v, v_scale, cache_dtype)
    rows = torch.nonzero(cache_lens >= 0).reshape(-1)
    if fresh_prefill:
        # active rows are at offset 0
        cache_k_l[rows, :, :S] = k_q[rows].transpose(1, 2)
        cache_v_l[rows, :, :S] = v_q[rows].transpose(1, 2)
    else:
        # per-row offset, clamped so the update fits (as
        # dynamic_update_slice clamps in the JAX package)
        start = cache_lens[rows].to(torch.int64).clamp(0, T - S)
        pos = start[:, None] + torch.arange(S, device=x.device)
        r = rows[:, None].expand_as(pos)
        cache_k_l[r, :, pos] = k_q[rows]
        cache_v_l[r, :, pos] = v_q[rows]

    if S > 1 and fresh_prefill:
        # fresh prefill attends over the S new (cache-rounded) keys only
        k_a = _dequantize_from_cache(k_q, k_scale, x.dtype, head_axis=2)
        v_a = _dequantize_from_cache(v_q, v_scale, x.dtype, head_axis=2)
        if use_kernels and S > 64:
            out = prefill_attention(q.contiguous(), k_a.contiguous(),
                                    v_a.contiguous())
        else:
            rep = H // KVH
            qg = q.reshape(B, S, KVH, rep, D).to(torch.float32)
            scores = torch.einsum("bskrd,btkd->bkrst", qg,
                                  k_a.to(torch.float32)) / math.sqrt(D)
            causal = torch.ones((S, S), dtype=torch.bool,
                                device=x.device).tril()
            scores = scores.masked_fill(~causal, -1e30)
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            out = torch.einsum("bkrst,btkd->bskrd", probs.to(torch.float32),
                               v_a.to(torch.float32)).to(x.dtype)
        out = out.reshape(B, S, H * D).to(x.dtype)
        return quantized_matmul(out, layer["o_proj"], use_kernels)

    keys = _dequantize_from_cache(cache_k_l, k_scale, x.dtype)
    values = _dequantize_from_cache(cache_v_l, v_scale, x.dtype)
    rep = H // KVH
    qg = q.reshape(B, S, KVH, rep, D).to(torch.float32)
    scores = torch.einsum("bskrd,bktd->bkrst", qg,
                          keys.to(torch.float32)) / math.sqrt(D)
    k_pos = torch.arange(T, device=x.device)[None, None, :]
    valid = cache_lens[:, None, None] + S
    mask = (k_pos <= positions[:, :, None]) & (k_pos < valid)  # (B, S, T)
    scores = scores.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkrst,bktd->bskrd", probs.to(torch.float32),
                       values.to(torch.float32)).to(x.dtype)
    return quantized_matmul(out.reshape(B, S, H * D), layer["o_proj"],
                            use_kernels)


def _mlp(layer: dict, x, config: LlamaConfig, use_kernels: bool = True):
    if "gate_up_proj" in layer:
        gu = quantized_matmul(x, layer["gate_up_proj"], use_kernels)
        split = layer["gate_up_split"]
        gate, up = gu[..., :split], gu[..., split:]
    else:
        gate = quantized_matmul(x, layer["gate_proj"], use_kernels)
        up = quantized_matmul(x, layer["up_proj"], use_kernels)
    return quantized_matmul(F.silu(gate) * up, layer["down_proj"], use_kernels)


def llama_forward(params: dict, config: LlamaConfig,
                  input_ids: torch.Tensor,     # (B, S)
                  positions: torch.Tensor,     # (B, S)
                  kv_cache: Optional[KVCache] = None,
                  fresh_prefill: Optional[bool] = None,
                  use_kernels: bool = True,
                  last_logit_only: bool = False):
    """Full forward pass. Returns (logits, kv cache); the cache tensors are
    updated in place and returned with lengths advanced by S.

    :param fresh_prefill: every active cache slot is empty (lengths 0);
        defaults to True when no cache is passed (one is created)
    :param use_kernels: run the hand-written kernels (their plain versions
        on the CPU); False selects the JAX package's non-kernel path
    :param last_logit_only: lm_head logits for the final position only
    """
    embed = params["embed_tokens"]
    embed_w = materialize_weight(embed) if isinstance(
        embed, QuantizedTensor) else embed
    x = embed_w[input_ids]
    B, S = input_ids.shape
    cos, sin = _rope(positions, config.head_dim, config.rope_theta)

    if fresh_prefill is None:
        fresh_prefill = kv_cache is None
    if kv_cache is None:
        kv_cache = init_kv_cache(config, B, S, dtype=x.dtype, device=x.device)
    cache_lens = kv_cache.lengths
    kv_k_all, kv_v_all = kv_cache.k, kv_cache.v
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["input_layernorm"], config.rms_norm_eps)
        attn_out, kv_k_all, kv_v_all = _attention(
            layer, i, h, cos, sin, kv_k_all, kv_v_all, cache_lens, config,
            positions, fresh_prefill=fresh_prefill, use_kernels=use_kernels)
        x = x + attn_out
        h = rms_norm(x, layer["post_attention_layernorm"], config.rms_norm_eps)
        x = x + _mlp(layer, h, config, use_kernels)

    x = rms_norm(x, params["norm"], config.rms_norm_eps)
    if last_logit_only:
        x = x[:, -1:, :]
    lm_head = params["lm_head"]
    if isinstance(lm_head, QuantizedTensor):
        logits = quantized_matmul(x, lm_head, use_kernels)
    else:
        logits = torch.matmul(x.to(torch.float32),
                              lm_head.to(torch.float32).t())
    return logits, KVCache(k=kv_k_all, v=kv_v_all,
                           lengths=(cache_lens + S).to(torch.int32))


def load_llama_params(path: str, dtype=torch.bfloat16, device="cuda",
                      use_kernels: bool = True
                      ) -> tuple[dict, LlamaConfig, Any]:
    """Load a compressed-tensors Llama checkpoint run compressed.

    :param device: where the params live; CUDA unless the caller asks for
        another device
    :param use_kernels: build the kernel weight layouts at load
    :return: (params, config, model_compressor)
    """
    from compressed_tensors_tpu_torch.compressors import (
        ModelCompressor,
        module_graph_from_names,
    )
    from compressed_tensors_tpu_torch.utils.safetensors_io import (
        CheckpointReader,
    )

    device = resolve_device(device)
    config = LlamaConfig.from_pretrained(path)
    if config.is_moe or config.is_mla or config.qk_norm:
        raise NotImplementedError(
            "MoE, MLA and Qwen3 q/k-norm checkpoints are not ported yet "
            "(ROADMAP A10)")
    mc = ModelCompressor.from_pretrained(path)
    reader = CheckpointReader(path)
    module_names = reader.module_names()
    schemes = (mc.resolve_schemes(module_graph_from_names(module_names))
               if mc is not None else {})

    def _tensor(name):
        return reader.get(name).to(device)

    def _get_qt(mod_name: str) -> QuantizedTensor:
        state = {k: v.to(device)
                 for k, v in reader.module_state_dict(mod_name).items()}
        qt = from_compressed_state(state, schemes.get(mod_name))
        if (qt.weight is not None and qt.weight.dtype.is_floating_point
                and qt.weight.dtype.itemsize > 1):
            qt = dataclasses.replace(qt, weight=qt.weight.to(dtype))
        return prepare_for_kernels(qt) if use_kernels else qt

    params: dict = {"layers": []}
    params["embed_tokens"] = materialize_weight(
        _get_qt("model.embed_tokens"), dtype=dtype)
    for i in range(config.num_hidden_layers):
        prefix = f"model.layers.{i}"
        layer: dict = {}
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            layer[proj] = _get_qt(f"{prefix}.self_attn.{proj}")
        for proj in ("gate_proj", "up_proj", "down_proj"):
            layer[proj] = _get_qt(f"{prefix}.mlp.{proj}")
        for norm in ("input_layernorm", "post_attention_layernorm"):
            layer[norm] = _tensor(f"{prefix}.{norm}.weight").to(dtype)
        attn_state = reader.module_state_dict(f"{prefix}.self_attn")
        if "q_scale" in attn_state:
            raise NotImplementedError(
                "query quantization (q_scale) is not ported yet")
        for sname in ("k_scale", "v_scale"):
            if sname in attn_state:
                layer[sname] = attn_state[sname].to(device)
        params["layers"].append(layer)
    params["norm"] = _tensor("model.norm.weight").to(dtype)
    params["lm_head"] = (_get_qt("lm_head") if "lm_head" in module_names
                         else params["embed_tokens"])
    reader.close()
    return params, config, mc
