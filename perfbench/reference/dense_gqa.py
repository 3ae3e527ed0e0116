"""Plain float32 reference of a dense GQA decoder (Qwen2 / Qwen3 as their
published modeling code describes them): RMSNorm, rotary embeddings in
the half-rotation layout, grouped-query causal attention with the Qwen2
qkv bias or the Qwen3 per-head q/k RMSNorm before the rotation, a SwiGLU
MLP, a final RMSNorm and an untied lm_head.

It reads the tensors the benchmark drew (``perfbench/models``), decodes
the pack-quantized words and scales itself, and runs layer by layer over
every sequence at once, with TF32 off. It imports nothing of the program.

``act_dtype=torch.float8_e4m3fn`` gives the fp8 control: what an fp8
W8A8 + fp8 KV cache deployment rounds, each with a per-row scale, the step
below the bf16 the configurations state: every decoder linear's input,
and K and V after the rotation (what the cache holds). The residual
stream, q and the lm_head's input stay f32, as such a deployment keeps
them at bf16.
"""

from __future__ import annotations

import contextlib
import math

import torch

from perfbench.models.dense_gqa import (
    LINEARS,
    has_bias,
    has_qk_norm,
    head_dim,
)

E4M3_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def dequantize(words: torch.Tensor, scales: torch.Tensor,
               group: int) -> torch.Tensor:
    """(N, K/8) int32 pack-quantized words and (N, K/g) scales -> (N, K)
    f32: code j of a row sits in bits 4j..4j+3 of its word, offset by 8."""
    b = words.contiguous().view(torch.uint8).to(torch.int16)
    codes = torch.stack([(b & 15) - 8, (b >> 4) - 8], dim=-1)
    codes = codes.reshape(words.shape[0], -1).to(torch.float32)
    return codes * scales.to(torch.float32).repeat_interleave(group, dim=1)


def _round(x: torch.Tensor, act_dtype) -> torch.Tensor:
    """x rounded to ``act_dtype`` with a per-row (last axis) scale, back in
    f32; f32 leaves x as it is."""
    if act_dtype == torch.float32:
        return x
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (x / s).to(act_dtype).to(torch.float32) * s


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rotate(x, pos, theta):
    """Rotary embedding, half-rotation layout; x (T, heads, D)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                        device=x.device) / d))
    ang = pos.to(torch.float64)[:, None] * inv[None]
    cos = torch.cat([ang.cos(), ang.cos()], -1).to(torch.float32)[:, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1).to(torch.float32)[:, None]
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + half * sin


class Weights:
    """The drawn tensors, dequantized to f32 one layer at a time."""

    def __init__(self, cfg: dict, raw: dict):
        self.cfg, self.raw = cfg, raw
        self.group = cfg["quantization"]["group_size"]

    def layer(self, i: int) -> dict:
        src = self.raw["layers"]
        out = {}
        for name in LINEARS:
            lin = src[name]
            out[name] = dequantize(lin["words"][i], lin["scales"][i],
                                   self.group)
            if lin["bias"] is not None:
                out[name + ".bias"] = lin["bias"][i].to(torch.float32)
        for name in ("input_layernorm", "post_attention_layernorm", "q_norm",
                     "k_norm"):
            if name in src:
                out[name] = src[name][i].to(torch.float32)
        return out


def _attention(q, k, v, block=512):
    """Causal GQA attention of one sequence: q (T, H, D), k/v (T, KVH, D),
    query rows in blocks."""
    T, H, D = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)   # (H, T, D)
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for s in range(0, T, block):
        e = min(T, s + block)
        qb = q[s:e].transpose(0, 1)                        # (H, b, D)
        scores = torch.matmul(qb, k[:, :e].transpose(1, 2)) / math.sqrt(D)
        rows = torch.arange(s, e, device=q.device)[:, None]
        cols = torch.arange(e, device=q.device)[None]
        scores = scores.masked_fill(cols > rows, float("-inf"))
        out[s:e] = torch.matmul(torch.softmax(scores, -1),
                                v[:, :e]).transpose(0, 1)
    return out


@torch.no_grad()
def logits(cfg: dict, raw: dict, seqs: list[list[int]],
           positions: list[list[int]], device,
           act_dtype=torch.float32) -> list[torch.Tensor]:
    """f32 logits of ``seqs[i]`` at ``positions[i]`` (each (len, vocab))."""
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    H, KVH, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 head_dim(cfg))
    weights = Weights(cfg, raw)
    with no_tf32():
        ids = [torch.tensor(s, dtype=torch.int64, device=device)
               for s in seqs]
        pos = [torch.arange(len(s), device=device) for s in seqs]
        hs = [raw["embed"][i].to(torch.float32) for i in ids]
        for li in range(cfg["num_hidden_layers"]):
            w = weights.layer(li)

            def lin(x, name):
                y = _round(x, act_dtype) @ w[name].t()
                return y + w[name + ".bias"] if name + ".bias" in w else y

            for j, x in enumerate(hs):
                T = x.shape[0]
                h = _rms(x, w["input_layernorm"], eps)
                q = lin(h, "q_proj").reshape(T, H, D)
                k = lin(h, "k_proj").reshape(T, KVH, D)
                v = lin(h, "v_proj").reshape(T, KVH, D)
                if has_qk_norm(cfg):
                    q = _rms(q, w["q_norm"], eps)
                    k = _rms(k, w["k_norm"], eps)
                q, k = _rotate(q, pos[j], theta), _rotate(k, pos[j], theta)
                k, v = _round(k, act_dtype), _round(v, act_dtype)
                a = _attention(q, k, v).reshape(T, H * D)
                x = x + lin(a, "o_proj")
                h = _rms(x, w["post_attention_layernorm"], eps)
                mlp = torch.nn.functional.silu(lin(h, "gate_proj")) * lin(
                    h, "up_proj")
                hs[j] = x + lin(mlp, "down_proj")
            del w
        head = raw["lm_head"].to(torch.float32)
        norm = raw["norm"].to(torch.float32)
        out = []
        for x, p in zip(hs, positions):
            h = _rms(x[torch.as_tensor(p, device=device)], norm, eps)
            out.append(h @ head.t())
        return out


def check_family(cfg: dict) -> None:
    """Raise where the configuration asks for what this reference lacks."""
    if cfg.get("tie_word_embeddings"):
        raise NotImplementedError("tied embeddings")
    if has_bias(cfg) and has_qk_norm(cfg):
        raise NotImplementedError("qkv bias together with q/k norms")
