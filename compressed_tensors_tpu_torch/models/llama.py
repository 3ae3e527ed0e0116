"""Llama-family forward pass over compressed-tensors checkpoints run
compressed, in PyTorch.

Counterpart of ``compressed_tensors_tpu/models/llama.py`` for the dense and
paged KV caches: GQA attention with the Qwen2 qkv bias, the Qwen3
per-head q/k RMSNorm and the fp8 fake-quant of q by ``q_scale``; DeepSeek
V2/V3 multi-head latent attention (``models/mla.py``); and MoE layers
(``models/moe.py``; Qwen-MoE, DeepSeek and Mixtral expert naming).
Every linear is a ``QuantizedTensor`` through ``quantized_matmul``, so
weights stay compressed on the device. The dense KV cache is
(L, B, KVH, S_pad, D) and the paged pool (L, NP, KVH, page, D), in the
cache dtype -- no lane padding of D and no head packing -- and both are
updated in place. An MLA cache holds one latent head: K rows [c_kv ;
k_pe] of width kv_lora_rank + qk_rope_head_dim and V rows c_kv of width
kv_lora_rank. A cache of fp8
e4m3 or int8 holds K/V divided by the checkpoint's per-layer
``k_scale``/``v_scale`` (per tensor, or per kv head).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from compressed_tensors_tpu_torch.flags import kernels_enabled
from compressed_tensors_tpu_torch.models.config import LlamaConfig
from compressed_tensors_tpu_torch.ops.kernels.decode_attention import (
    decode_attention,
)
from compressed_tensors_tpu_torch.ops.kernels.flash_decode import (
    flash_decode_attention,
)
from compressed_tensors_tpu_torch.ops.kernels.paged_decode import (
    paged_decode_attention,
)
from compressed_tensors_tpu_torch.ops.kernels.prefill_attention import (
    prefill_attention,
)
from compressed_tensors_tpu_torch.ops.linear import (
    QuantizedTensor,
    _transcode_fp8_enabled,
    from_compressed_state,
    materialize_weight,
    permute_output_rows,
    prepare_for_kernels,
    quantized_matmul,
    stack_quantized_tensors,
)
from compressed_tensors_tpu_torch.utils.dtypes import byte_view

__all__ = [
    "LlamaConfig",
    "KVCache",
    "PagedKVCache",
    "cache_heads",
    "init_kv_cache",
    "init_paged_kv_cache",
    "llama_forward",
    "load_llama_params",
    "resolve_device",
    "transcode_fp8_kv_to_int8",
]

# |x| above which a cast to fp8 e4m3 overflows (448 plus half an ulp)
_E4M3_OVERFLOW = 464.0


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another; asking for CUDA without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return device


def _zeros(shape, dtype, device) -> torch.Tensor:
    """A zeroed cache buffer (fp8 ones zeroed through their byte view)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    byte_view(out).zero_()
    return out


@dataclasses.dataclass
class KVCache:
    """Dense KV cache with per-slot lengths (every batch row is an
    independent sequence slot). k/v: (L, B, KVH, S_pad, D)."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor  # (B,) int32: valid prefix length per slot


def cache_heads(config: LlamaConfig) -> tuple[int, int, int]:
    """(kv heads, K width, V width) of a cache row: the model's GQA heads,
    or MLA's one latent head with K rows [c_kv ; k_pe] and V rows c_kv
    (the JAX package pads both to 128 lanes and stores V as [c_kv ; 0])."""
    if config.is_mla:
        r = config.kv_lora_rank
        return 1, r + config.qk_rope_head_dim, r
    return config.num_key_value_heads, config.head_dim, config.head_dim


def init_kv_cache(config: LlamaConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, cache_dtype=None,
                  device="cuda") -> KVCache:
    """Zeroed cache with S_pad = max_len rounded up to a multiple of 64."""
    device = resolve_device(device)
    s_pad = -(-max_len // 64) * 64
    kvh, dk, dv = cache_heads(config)
    lead = (config.num_hidden_layers, batch, kvh, s_pad)
    cd = cache_dtype or dtype
    return KVCache(
        k=_zeros((*lead, dk), cd, device),
        v=_zeros((*lead, dv), cd, device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


@dataclasses.dataclass
class PagedKVCache:
    """Paged KV cache: a page pool shared by all sequences plus per-row
    page tables. Page 0 is the null page: unallocated table entries and
    released rows point at it; its contents are garbage and never read into
    a live sequence."""

    k: torch.Tensor        # (L, NP, KVH, page, D) pool
    v: torch.Tensor
    tables: torch.Tensor   # (B, P_max) int32 page ids
    lengths: torch.Tensor  # (B,) int32 valid prefix length per row

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def max_len(self) -> int:
        return self.tables.shape[1] * self.k.shape[3]


def init_paged_kv_cache(config: LlamaConfig, batch: int, max_len: int,
                        num_pages: int | None = None, page_size: int = 64,
                        dtype=torch.bfloat16, cache_dtype=None,
                        device="cuda") -> PagedKVCache:
    """Zeroed pool and all-null tables. ``num_pages`` defaults to full
    residency: ``batch`` sequences of ``max_len`` plus the null page."""
    device = resolve_device(device)
    p_max = -(-max_len // page_size)
    if num_pages is None:
        num_pages = batch * p_max + 1
    kvh, dk, dv = cache_heads(config)
    lead = (config.num_hidden_layers, num_pages, kvh, page_size)
    cd = cache_dtype or dtype
    return PagedKVCache(
        k=_zeros((*lead, dk), cd, device),
        v=_zeros((*lead, dv), cd, device),
        tables=torch.zeros((batch, p_max), dtype=torch.int32, device=device),
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


def _to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """f32 -> fp8 e4m3, round to nearest even. An overflow casts to NaN, as
    in XLA and ml_dtypes (newer PyTorch versions saturate): no silent
    clip."""
    x = torch.where(x.abs() > _E4M3_OVERFLOW,
                    torch.full_like(x, float("nan")), x)
    return x.to(torch.float8_e4m3fn)


def _quantize_to_cache(x, scale, cache_dtype, head_axis=2):
    """Quantize post-RoPE K/V into the cache representation with the
    serialized k_scale/v_scale (fp8 or int8 caches)."""
    if scale is None or cache_dtype == x.dtype:
        return x.to(cache_dtype)
    scaled = x.to(torch.float32) / _cache_scale(scale, x.ndim, head_axis)
    if cache_dtype == torch.float8_e4m3fn:
        return _to_e4m3(scaled)
    if cache_dtype.is_floating_point:
        return scaled.to(cache_dtype)
    return torch.round(scaled).clamp(-128, 127).to(cache_dtype)


def _dequantize_from_cache(x, scale, dtype, head_axis=1):
    """Inverse of _quantize_to_cache; cache views are (B, KVH, T, D)."""
    if scale is None or x.dtype == dtype:
        return x.to(dtype)
    return (x.to(torch.float32) * _cache_scale(scale, x.ndim, head_axis)).to(
        dtype)


def transcode_fp8_kv_to_int8(params: dict, cache_dtype):
    """Serve an fp8-KV checkpoint with an int8 cache instead, where the
    ``fp8_transcode`` flag asks for it (the JAX package's workaround for
    chips without fp8 conversion; the H100 has it, so "auto" keeps fp8).

    The checkpoint scale s maps x onto the fp8 lattice (max 448) as x / s;
    the int8 cache stores x / (s * 448 / 127), so the same range covers the
    int8 lattice (max 127).

    :return: (params, cache_dtype): copies with rescaled per-layer
        k_scale/v_scale and torch.int8 when the transcode applies, the
        arguments unchanged otherwise
    """
    if cache_dtype is None or not (cache_dtype.is_floating_point
                                   and cache_dtype.itemsize == 1):
        return params, cache_dtype
    if not _transcode_fp8_enabled():
        return params, cache_dtype
    ratio = 448.0 / 127.0
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        new_layer = dict(layer)
        for key in ("k_scale", "v_scale"):
            if layer.get(key) is not None:
                new_layer[key] = (layer[key].to(torch.float32)
                                  * ratio).to(layer[key].dtype)
        out["layers"].append(new_layer)
    return out, torch.int8


def _attention(layer: dict, layer_idx: int, x, cos, sin, kv_k_all, kv_v_all,
               cache_lens, config: LlamaConfig, positions,
               fresh_prefill: bool = False, tables=None,
               use_kernels: bool = True):
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
    # Qwen3-style per-head q/k RMSNorm (over head_dim, before RoPE)
    if "q_norm" in layer:
        q = rms_norm(q, layer["q_norm"], config.rms_norm_eps)
    if "k_norm" in layer:
        k = rms_norm(k, layer["k_norm"], config.rms_norm_eps)
    q = _apply_rope(q, cos, sin)
    k = _apply_rope(k, cos, sin)
    # post-RoPE query quantization: fp8 e4m3 fake-quant by the checkpoint's
    # q_scale (per tensor, or per head on q's head axis)
    q_scale = layer.get("q_scale")
    if q_scale is not None:
        s = _cache_scale(q_scale, q.ndim, head_axis=2)
        q = (_to_e4m3(q.to(torch.float32) / s).to(torch.float32) * s).to(
            x.dtype)

    k_scale, v_scale = layer.get("k_scale"), layer.get("v_scale")
    # both scales present or absent; the flash and paged kernels take
    # per-tensor scales only (per-head ones ride the block kernel)
    scales_ok = (k_scale is None) == (v_scale is None)
    scalar_scales = scales_ok and (k_scale is None or (
        k_scale.numel() == 1 and v_scale.numel() == 1))

    def project(out):
        out = out.reshape(B, S, H * D).to(x.dtype)
        return row_matmul(out, layer, "o_proj", use_kernels)

    def step():  # the decode kernels' (B, heads, D) operands
        return (q[:, 0].contiguous(), k[:, 0].contiguous(),
                v[:, 0].contiguous())

    if tables is not None and S == 1 and use_kernels and scalar_scales:
        out, kv_k_all, kv_v_all = paged_decode_attention(
            *step(), kv_k_all, kv_v_all, tables, cache_lens, layer=layer_idx,
            k_scale=k_scale, v_scale=v_scale)
        return project(out), kv_k_all, kv_v_all

    if tables is not None:
        # paged prefill: gather the rows' pages into a contiguous view, run
        # the dense tail on it, scatter the pages back (duplicate table ids
        # only ever point at the null page 0, whose contents are garbage)
        P, page = tables.shape[1], kv_k_all.shape[3]
        idx = tables.to(torch.int64)

        def gather(pool):
            return byte_view(pool[layer_idx])[idx].permute(
                0, 2, 1, 3, 4).reshape(B, KVH, P * page, D).view(pool.dtype)

        dense_k, dense_v = gather(kv_k_all), gather(kv_v_all)
        out = _attention_dense_tail(
            layer, x, q, k, v, dense_k, dense_v, cache_lens, config,
            positions, fresh_prefill, k_scale, v_scale, use_kernels)
        flat = idx.reshape(-1)
        for pool, dense in ((kv_k_all, dense_k), (kv_v_all, dense_v)):
            byte_view(pool[layer_idx])[flat] = byte_view(dense).reshape(
                B, KVH, P, page, D).permute(0, 2, 1, 3, 4).reshape(
                    B * P, KVH, page, D)
        return out, kv_k_all, kv_v_all

    if S == 1 and use_kernels and scales_ok:
        from compressed_tensors_tpu_torch.flags import FLAGS

        # the block kernel for small allocations, flash decode (chunks of
        # the live prefix only) for serving-scale ones, as in the JAX
        # package; only the block kernel takes per-head scales
        s_max = kv_k_all.shape[3]
        use_flash = scalar_scales and s_max % 64 == 0 and (
            FLAGS.decode_attn == "flash"
            or (FLAGS.decode_attn == "auto" and s_max >= 512))
        kernel = flash_decode_attention if use_flash else decode_attention
        out, kv_k_all, kv_v_all = kernel(
            *step(), kv_k_all, kv_v_all, cache_lens, layer=layer_idx,
            k_scale=k_scale, v_scale=v_scale)
        return project(out), kv_k_all, kv_v_all

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
    ck_b, cv_b = byte_view(cache_k_l), byte_view(cache_v_l)
    if fresh_prefill:
        # active rows are at offset 0
        ck_b[rows, :, :S] = byte_view(k_q)[rows].transpose(1, 2)
        cv_b[rows, :, :S] = byte_view(v_q)[rows].transpose(1, 2)
    else:
        # per-row offset, clamped so the update fits (as
        # dynamic_update_slice clamps in the JAX package)
        start = cache_lens[rows].to(torch.int64).clamp(0, T - S)
        pos = start[:, None] + torch.arange(S, device=x.device)
        r = rows[:, None].expand_as(pos)
        ck_b[r, :, pos] = byte_view(k_q)[rows]
        cv_b[r, :, pos] = byte_view(v_q)[rows]

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
        return row_matmul(out, layer, "o_proj", use_kernels)

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
    return row_matmul(out.reshape(B, S, H * D), layer, "o_proj", use_kernels)


def _mlp(layer: dict, x, config: LlamaConfig, use_kernels: bool = True,
         dp_block: bool = False):
    if "moe" in layer:
        from compressed_tensors_tpu_torch.models.moe import moe_mlp

        return moe_mlp(layer, x, config, use_kernels=use_kernels,
                       dp_block=dp_block)
    if "gate_up_proj" in layer:
        gu = quantized_matmul(x, layer["gate_up_proj"], use_kernels)
        split = layer["gate_up_split"]
        gate, up = gu[..., :split], gu[..., split:]
    else:
        gate = quantized_matmul(x, layer["gate_proj"], use_kernels)
        up = quantized_matmul(x, layer["up_proj"], use_kernels)
    return row_matmul(F.silu(gate) * up, layer, "down_proj", use_kernels)


def row_matmul(x, layer: dict, name: str, use_kernels: bool = True):
    """``layer[name]`` applied to x: ``quantized_matmul``, or, where the
    layer's shard makes it row-parallel, the rank's partial product summed
    over the mesh's "tp" axis (``parallel.mesh.row_parallel_matmul``)."""
    shard = layer.get("shard")
    if shard is None or name not in shard.rows:
        return quantized_matmul(x, layer[name], use_kernels)
    from compressed_tensors_tpu_torch.parallel.mesh import (
        row_parallel_matmul,
    )

    return row_parallel_matmul(x, layer[name], shard.mesh,
                               name in shard.replicated_inputs, use_kernels)


def _embed(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows of ``input_ids`` (a vocabulary-sharded table: the
    rank's masked lookup summed over "tp")."""
    embed = params["embed_tokens"]
    embed_w = materialize_weight(embed) if isinstance(
        embed, QuantizedTensor) else embed
    shard = params.get("shard")
    if shard is not None:
        return shard.embed(embed_w, input_ids)
    return embed_w[input_ids]


def _lm_head(params: dict, x, config: LlamaConfig, use_kernels: bool,
             last_only: bool = False):
    """Final norm and lm_head logits, of the last position only where
    ``last_only`` (a vocabulary-sharded head's gathered over "tp")."""
    x = rms_norm(x, params["norm"], config.rms_norm_eps)
    if last_only:
        x = x[:, -1:, :]
    lm_head = params["lm_head"]
    if isinstance(lm_head, QuantizedTensor):
        logits = quantized_matmul(x, lm_head, use_kernels)
    else:
        logits = torch.matmul(x.to(torch.float32),
                              lm_head.to(torch.float32).t())
    shard = params.get("shard")
    return shard.logits(logits) if shard is not None else logits


def llama_forward(params: dict, config: LlamaConfig,
                  input_ids: torch.Tensor,     # (B, S)
                  positions: torch.Tensor,     # (B, S)
                  kv_cache: KVCache | PagedKVCache | None = None,
                  fresh_prefill: Optional[bool] = None,
                  use_kernels: bool = True,
                  last_logit_only: bool = False,
                  dp_block: bool = False):
    """Full forward pass. Returns (logits, kv cache); the cache tensors are
    updated in place and returned with lengths advanced by S.

    :param kv_cache: a dense ``KVCache`` or a ``PagedKVCache``; rows with a
        negative length are inactive (their cache bytes stay untouched)
    :param fresh_prefill: every active cache slot is empty (lengths 0);
        defaults to True when no cache is passed (one is created)
    :param use_kernels: run the hand-written kernels (their plain versions
        on the CPU); False selects the JAX package's non-kernel path
    :param last_logit_only: lm_head logits for the final position only
    :param dp_block: the rows are this rank's dp block of the global batch
        (``parallel.mesh.dp_rows``; the dense cache holds the same block):
        MoE layers count capacity over every block's rows. False: the
        rows are the whole batch (dp-replicated params gather nothing)
    """
    use_kernels = kernels_enabled(use_kernels)
    shard = params.get("shard")
    if shard is not None:
        # a rank's slice of sharded params (parallel.mesh): local heads,
        # the collectives of its mesh
        shard.mesh.require_groups()
        config = shard.local_config(config)
    x = _embed(params, input_ids)
    B, S = input_ids.shape
    rope_dim = config.qk_rope_head_dim if config.is_mla else config.head_dim
    cos, sin = _rope(positions, rope_dim, config.rope_theta)

    if fresh_prefill is None:
        fresh_prefill = kv_cache is None
    if kv_cache is None:
        kv_cache = init_kv_cache(config, B, S, dtype=x.dtype, device=x.device)
    cache_lens = kv_cache.lengths
    tables = kv_cache.tables if isinstance(kv_cache, PagedKVCache) else None
    kv_k_all, kv_v_all = kv_cache.k, kv_cache.v
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["input_layernorm"], config.rms_norm_eps)
        if config.is_mla:
            from compressed_tensors_tpu_torch.models.mla import mla_attention

            attn_out, kv_k_all, kv_v_all = mla_attention(
                layer, i, h, cos, sin, kv_k_all, kv_v_all, cache_lens,
                config, positions, use_kernels=use_kernels, tables=tables)
        else:
            attn_out, kv_k_all, kv_v_all = _attention(
                layer, i, h, cos, sin, kv_k_all, kv_v_all, cache_lens,
                config, positions, fresh_prefill=fresh_prefill,
                tables=tables, use_kernels=use_kernels)
        x = x + attn_out
        h = rms_norm(x, layer["post_attention_layernorm"], config.rms_norm_eps)
        x = x + _mlp(layer, h, config, use_kernels, dp_block)

    logits = _lm_head(params, x, config, use_kernels, last_logit_only)
    lengths = (cache_lens + S).to(torch.int32)
    if tables is not None:
        return logits, PagedKVCache(k=kv_k_all, v=kv_v_all, tables=tables,
                                    lengths=lengths)
    return logits, KVCache(k=kv_k_all, v=kv_v_all, lengths=lengths)


def load_llama_params(path: str, dtype=torch.bfloat16, device="cuda",
                      use_kernels: bool = True, mesh=None
                      ) -> tuple[dict, LlamaConfig, Any]:
    """Load a compressed-tensors Llama checkpoint run compressed.

    :param device: where the params live; CUDA unless the caller asks for
        another device
    :param use_kernels: build the kernel weight layouts at load
    :param mesh: a ``parallel.make_mesh`` mesh that splits tp: each rank
        reads only the blocks of its shard (``parallel.mesh.
        ShardedCheckpointReader``; the same blocks at every dp index) and
        gets the params ``shard_llama_params`` would give it; dense GQA
        models only
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
    mc = ModelCompressor.from_pretrained(path)
    reader = CheckpointReader(path)
    module_names = reader.module_names()
    tensor_names = set(reader.tensor_names())
    schemes = (mc.resolve_schemes(module_graph_from_names(module_names))
               if mc is not None else {})
    sharded = mesh is not None and (mesh.shape["tp"] > 1
                                    or mesh.shape["ep"] > 1)
    if sharded:
        from compressed_tensors_tpu_torch.parallel.mesh import (
            ShardedCheckpointReader,
        )

        reader.close()
        reader = ShardedCheckpointReader(path, config, schemes, mesh)

    def _tensor(name):
        return reader.get(name).to(device)

    def _get_qt(mod_name: str, kernels: bool | None = None,
                perm_out=None) -> QuantizedTensor:
        state = {k: v.to(device)
                 for k, v in reader.module_state_dict(mod_name).items()}
        qt = from_compressed_state(state, schemes.get(mod_name))
        if (qt.weight is not None and qt.weight.dtype.is_floating_point
                and qt.weight.dtype.itemsize > 1):
            qt = dataclasses.replace(qt, weight=qt.weight.to(dtype))
        if perm_out is not None:
            qt = permute_output_rows(qt, perm_out)
        if kernels if kernels is not None else use_kernels:
            qt = prepare_for_kernels(qt)
        return qt

    def _load_moe(prefix: str) -> dict | None:
        """The stacked-expert MoE block of a layer, or None: Qwen/DeepSeek
        naming (``mlp.experts.N.{gate,up,down}_proj`` with the ``mlp.gate``
        router and an optional ``mlp.shared_expert`` or
        ``mlp.shared_experts``) or Mixtral naming
        (``block_sparse_moe.experts.N.{w1,w3,w2}`` with
        ``block_sparse_moe.gate``). Experts stack in checkpoint layout,
        then take the stacked kernel layouts where they have one."""
        styles = ((f"{prefix}.mlp", ("gate_proj", "up_proj", "down_proj")),
                  (f"{prefix}.block_sparse_moe", ("w1", "w3", "w2")))
        for base, src_names in styles:
            if f"{base}.experts.0.{src_names[0]}" not in module_names:
                continue
            E = config.num_local_experts or sum(
                1 for m in module_names
                if m.startswith(f"{base}.experts.")
                and m.endswith(f".{src_names[0]}"))

            def stacked(src):
                st = stack_quantized_tensors([
                    _get_qt(f"{base}.experts.{j}.{src}", kernels=False)
                    for j in range(E)])
                return prepare_for_kernels(st) if use_kernels else st

            moe: dict = {
                "router": reader.module_state_dict(f"{base}.gate")[
                    "weight"].to(device=device, dtype=dtype),
                "experts": {dst: stacked(src) for src, dst in zip(
                    src_names, ("gate_proj", "up_proj", "down_proj"))},
            }
            for shared in ("shared_expert", "shared_experts"):
                if f"{base}.{shared}.gate_proj" in module_names:
                    moe["shared_expert"] = {
                        p: _get_qt(f"{base}.{shared}.{p}")
                        for p in ("gate_proj", "up_proj", "down_proj")}
                    break
            return moe
        return None

    def _load_mla(prefix: str) -> dict:
        """A DeepSeek MLA layer's projections and latent norms. The rope
        rows of ``kv_a_proj_with_mqa`` and of the q projection are permuted
        from the interleaved to the half layout when the checkpoint is
        interleaved (``mla_rope_perms``); ``kv_b_proj`` keeps its checkpoint
        layout (no matmul kernel reads it) and is dequantized once here into
        the absorbed ``w_kb``/``w_vb``."""
        from compressed_tensors_tpu_torch.models.mla import (
            kv_b_weights,
            mla_rope_perms,
        )

        attn = f"{prefix}.self_attn"
        perms = mla_rope_perms(config) if config.rope_interleaved else {}
        projs = ["kv_a_proj_with_mqa", "kv_b_proj", "o_proj"]
        out: dict = {}
        if f"{attn}.q_a_proj" in module_names:
            projs += ["q_a_proj", "q_b_proj"]
            out["q_a_layernorm"] = _tensor(
                f"{attn}.q_a_layernorm.weight").to(dtype)
        else:
            projs.append("q_proj")
        for proj in projs:
            out[proj] = _get_qt(f"{attn}.{proj}",
                                kernels=False if proj == "kv_b_proj" else None,
                                perm_out=perms.get(proj))
        out["kv_a_layernorm"] = _tensor(
            f"{attn}.kv_a_layernorm.weight").to(dtype)
        out["w_kb"], out["w_vb"] = kv_b_weights(out, config, dtype)
        return out

    params: dict = {"layers": []}
    params["embed_tokens"] = materialize_weight(
        _get_qt("model.embed_tokens"), dtype=dtype)
    for i in range(config.num_hidden_layers):
        prefix = f"model.layers.{i}"
        layer: dict = {}
        if config.is_mla:
            layer.update(_load_mla(prefix))
        else:
            for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
                layer[proj] = _get_qt(f"{prefix}.self_attn.{proj}")
        moe = _load_moe(prefix)
        if moe is not None:
            layer["moe"] = moe
        else:
            for proj in ("gate_proj", "up_proj", "down_proj"):
                layer[proj] = _get_qt(f"{prefix}.mlp.{proj}")
        for norm in ("input_layernorm", "post_attention_layernorm"):
            layer[norm] = _tensor(f"{prefix}.{norm}.weight").to(dtype)
        attn_state = reader.module_state_dict(f"{prefix}.self_attn")
        for sname in ("k_scale", "v_scale", "q_scale"):
            if sname in attn_state:
                layer[sname] = attn_state[sname].to(device)
        # Qwen3-style per-head q/k norms
        for nname in ("q_norm", "k_norm"):
            full = f"{prefix}.self_attn.{nname}.weight"
            if full in tensor_names:
                layer[nname] = _tensor(full).to(dtype)
        params["layers"].append(layer)
    params["norm"] = _tensor("model.norm.weight").to(dtype)
    params["lm_head"] = (_get_qt("lm_head") if "lm_head" in module_names
                         else params["embed_tokens"])
    reader.close()
    if sharded:
        params = reader.finish(params)
    return params, config, mc
