"""DeepSeek V2/V3 multi-head latent attention (MLA), run compressed.

Counterpart of ``compressed_tensors_tpu/models/mla.py``. The KV cache holds
one latent "head" a token: K rows [c_kv ; k_pe] (kv_lora_rank +
qk_rope_head_dim wide) and V rows c_kv (kv_lora_rank wide), with no lane
padding (the JAX package pads both rows to 128 lanes and stores V as
[c_kv ; 0]). The two tensors stay apart as in the JAX package: with k/v
scales, K holds c_kv / k_scale and V holds c_kv / v_scale.

Decode takes the absorbed form: the k side of kv_b_proj folds into the
query (q_c = q_nope W_kb, head by head), which turns MLA into attention of
``h`` query heads over one latent head. The latent-head decode kernels run
it (``decode_attention`` on the slab, ``paged_decode_attention`` on pages,
their B5-L/B7-L entry points):

    scores_h = [q_c_h ; q_pe_h] . [c_kv ; k_pe] / sqrt(nope + rope)
    out_h    = softmax(scores_h) @ c_kv
    attn_h   = out_h @ W_vb_h

Prefill (and ``use_kernels=False`` at every step) runs the non-absorbed
form: the latents are written into the cache in its representation, read
back, expanded through kv_b_proj, and attended by plain causal attention
(the JAX package has no MLA prefill kernel, so these stay ``torch.einsum``
as the JAX package leaves them to XLA). A paged prefill gathers the rows'
pages into a contiguous view, runs the dense form on it and scatters the
pages back.

kv_b_proj is read as a dense matrix, never through a matmul kernel: the
loader keeps it in checkpoint layout and dequantizes it once into
``w_kb`` (h, nope, r) and ``w_vb`` (h, vd, r) in the model dtype, the
values the JAX package dequantizes in every forward. RoPE uses the half
rotation; interleaved checkpoints are converted at load
(``mla_rope_perms``).
"""

from __future__ import annotations

import numpy as np
import torch

from compressed_tensors_tpu_torch.models.config import LlamaConfig
from compressed_tensors_tpu_torch.models.llama import (
    _apply_rope,
    _dequantize_from_cache,
    _quantize_to_cache,
    rms_norm,
    row_matmul,
)
from compressed_tensors_tpu_torch.ops.kernels.decode_attention import (
    decode_attention,
)
from compressed_tensors_tpu_torch.ops.kernels.paged_decode import (
    paged_decode_attention,
)
from compressed_tensors_tpu_torch.ops.linear import (
    materialize_weight,
    quantized_matmul,
)
from compressed_tensors_tpu_torch.utils.dtypes import byte_view

__all__ = ["mla_attention", "kv_b_weights", "mla_rope_perms"]


def mla_rope_perms(config: LlamaConfig) -> dict[str, torch.Tensor]:
    """Output-row permutations from the interleaved (GPT-J) rope layout of
    DeepSeek checkpoints to the half layout, by projection name: the rope
    rows of ``kv_a_proj_with_mqa`` (after the kv_lora_rank latent rows)
    and of each head of ``q_proj``/``q_b_proj`` (after its nope rows).
    rot_half(P x) == P rot_interleaved(x), so the attention dots are the
    interleaved ones. A writer applies ``argsort`` of each to go back."""
    rope_d, nope = config.qk_rope_head_dim, config.qk_nope_head_dim
    r, qk_d = config.kv_lora_rank, nope + rope_d
    il2half = torch.cat([torch.arange(0, rope_d, 2),
                         torch.arange(1, rope_d, 2)])
    kv_a = torch.cat([torch.arange(r), r + il2half])
    head = torch.cat([torch.arange(nope), nope + il2half])
    q = torch.cat([h * qk_d + head
                   for h in range(config.num_attention_heads)])
    return {"kv_a_proj_with_mqa": kv_a, "q_proj": q, "q_b_proj": q}


def kv_b_weights(layer: dict, config: LlamaConfig, dtype):
    """(w_kb (h, nope, r), w_vb (h, vd, r)) of the layer's kv_b_proj in
    ``dtype``: the loader's absorbed copies where the layer has them,
    else dequantized from the checkpoint layout."""
    if "w_kb" in layer:
        return layer["w_kb"].to(dtype), layer["w_vb"].to(dtype)
    h, nope = config.num_attention_heads, config.qk_nope_head_dim
    w = materialize_weight(layer["kv_b_proj"], dtype=dtype).reshape(
        h, nope + config.v_head_dim, config.kv_lora_rank)
    return w[:, :nope].contiguous(), w[:, nope:].contiguous()


def mla_attention(layer: dict, layer_idx: int, x, cos, sin, kv_k_all,
                  kv_v_all, cache_lens, config: LlamaConfig, positions,
                  use_kernels: bool = True, tables=None):
    """One MLA attention block on the normed hidden states ``x`` (B, S,
    H). The caches are (L, B, 1, S_pad, Dk/Dv), or with ``tables`` the page
    pools (L, NP, 1, page, Dk/Dv), updated in place. Returns (o_proj
    output, kv_k_all, kv_v_all)."""
    B, S, _ = x.shape
    h = config.num_attention_heads
    nope, rope_d = config.qk_nope_head_dim, config.qk_rope_head_dim
    r, vd = config.kv_lora_rank, config.v_head_dim
    qk_d = nope + rope_d
    eps = config.rms_norm_eps

    if "q_a_proj" in layer:
        qa = quantized_matmul(x, layer["q_a_proj"], use_kernels)
        qa = rms_norm(qa, layer["q_a_layernorm"], eps)
        q = quantized_matmul(qa, layer["q_b_proj"], use_kernels)
    else:
        q = quantized_matmul(x, layer["q_proj"], use_kernels)
    q = q.reshape(B, S, h, qk_d)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    kv_a = quantized_matmul(x, layer["kv_a_proj_with_mqa"], use_kernels)
    c_kv = rms_norm(kv_a[..., :r], layer["kv_a_layernorm"], eps)
    q_pe = _apply_rope(q_pe, cos, sin)
    k_pe = _apply_rope(kv_a[..., r:][:, :, None, :], cos, sin)[:, :, 0]
    lat_k = torch.cat([c_kv, k_pe], dim=-1)           # (B, S, r + rope)
    w_kb, w_vb = kv_b_weights(layer, config, x.dtype)
    k_scale, v_scale = layer.get("k_scale"), layer.get("v_scale")

    def project(attn):  # (B, S, h, vd) -> o_proj
        return row_matmul(attn.reshape(B, S, h * vd).to(x.dtype), layer,
                          "o_proj", use_kernels)

    if S == 1 and use_kernels and (k_scale is None) == (v_scale is None):
        # absorbed decode: h query heads over the one latent head
        q_c = torch.einsum("bhd,hdr->bhr", q_nope[:, 0], w_kb)
        q_cat = torch.cat([q_c, q_pe[:, 0]], dim=-1).contiguous()
        new_k = lat_k[:, :1].contiguous()              # (B, 1, r + rope)
        new_v = c_kv[:, :1].contiguous()               # (B, 1, r)
        kw = dict(layer=layer_idx, k_scale=k_scale, v_scale=v_scale,
                  true_d=qk_d)
        if tables is not None:
            out, kv_k_all, kv_v_all = paged_decode_attention(
                q_cat, new_k, new_v, kv_k_all, kv_v_all, tables, cache_lens,
                **kw)
        else:
            out, kv_k_all, kv_v_all = decode_attention(
                q_cat, new_k, new_v, kv_k_all, kv_v_all, cache_lens, **kw)
        attn = torch.einsum("bhr,hvr->bhv", out.to(x.dtype), w_vb)
        return project(attn), kv_k_all, kv_v_all

    if tables is not None:
        # paged prefill: the rows' pages gathered into a contiguous
        # one-layer slab, the dense form on it, the pages scattered back
        # (duplicate table ids only ever point at the null page 0)
        P, page = tables.shape[1], kv_k_all.shape[3]
        idx = tables.to(torch.int64)

        def gather(pool):
            d = pool.shape[-1]
            return byte_view(pool[layer_idx])[idx].permute(
                0, 2, 1, 3, 4).reshape(1, B, 1, P * page, d).view(pool.dtype)

        dense_k, dense_v = gather(kv_k_all), gather(kv_v_all)
        out, _, _ = mla_attention(layer, 0, x, cos, sin, dense_k, dense_v,
                                  cache_lens, config, positions,
                                  use_kernels=use_kernels)
        flat = idx.reshape(-1)
        for pool, dense in ((kv_k_all, dense_k), (kv_v_all, dense_v)):
            d = pool.shape[-1]
            byte_view(pool[layer_idx])[flat] = byte_view(dense[0]).reshape(
                B, 1, P, page, d).permute(0, 2, 1, 3, 4).reshape(
                    B * P, 1, page, d)
        return out, kv_k_all, kv_v_all

    # non-absorbed form: write the latents at [len_b, len_b + S) (rows
    # with a negative length are inactive; the start clamps so the rows
    # fit, as dynamic_update_slice clamps in the JAX package)
    ck, cv = kv_k_all[layer_idx], kv_v_all[layer_idx]  # (B, 1, T, Dk/Dv)
    T = ck.shape[2]
    k_q = _quantize_to_cache(lat_k, k_scale, ck.dtype)
    v_q = _quantize_to_cache(c_kv, v_scale, cv.dtype)
    rows = torch.nonzero(cache_lens >= 0).reshape(-1)
    start = cache_lens[rows].to(torch.int64).clamp(0, T - S)
    pos = start[:, None] + torch.arange(S, device=x.device)
    rr = rows[:, None].expand_as(pos)
    byte_view(ck)[rr, 0, pos] = byte_view(k_q)[rows]
    byte_view(cv)[rr, 0, pos] = byte_view(v_q)[rows]

    # attend over the cached latents read back (rounded as decode reads
    # them), expanded through kv_b_proj
    lat = _dequantize_from_cache(ck[:, 0], k_scale, x.dtype)   # (B, T, Dk)
    c_all, kpe_all = lat[..., :r], lat[..., r:]
    k_nope = torch.einsum("btr,hdr->bthd", c_all, w_kb)
    v_all = torch.einsum("btr,hvr->bthv", c_all, w_vb)
    k_all = torch.cat([k_nope, kpe_all[:, :, None, :].expand(B, T, h, rope_d)],
                      dim=-1)                                   # (B, T, h, qk)
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    # 1/sqrt(qk_d) rounded as the JAX package computes it, in f32
    inv_sqrt = float(np.float32(1.0) / np.sqrt(np.float32(qk_d)))
    scores = torch.einsum("bshd,bthd->bhst", q_full.to(torch.float32),
                          k_all.to(torch.float32)) * inv_sqrt
    k_pos = torch.arange(T, device=x.device)[None, None, None, :]
    valid = (cache_lens.to(torch.int64) + S)[:, None, None, None]
    mask = (k_pos <= positions[:, None, :, None]) & (k_pos < valid)
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    attn = torch.einsum("bhst,bthv->bshv", probs.to(torch.float32),
                        v_all.to(torch.float32)).to(x.dtype)
    return project(attn), kv_k_all, kv_v_all
