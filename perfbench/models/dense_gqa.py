"""The draw of a dense GQA decoder (Llama layout: the Qwen2 qkv bias and
the Qwen3 per-head q/k RMSNorm by the configuration's keys), W4A16 g128
symmetric pack-quantized on every decoder linear, bf16 embeddings and an
untied bf16 lm_head.

Everything is drawn on the device from the seed with one
``torch.Generator``, one call per tensor kind over all layers, in a fixed
order, so the same seed gives the same tensors, and the reference can draw
them again after the program has been freed.

Codes are uniform in [-7, 7] (no -8: a nonzero mean code would turn every
linear's output toward one direction). Each linear's weights have an RMS of
``gain / sqrt(K)`` with the gains of the configuration's ``draw`` block, so
activations stay near unit scale through the depth, each sublayer adds a
part of the residual, and attention scores spread over a few units (peaked
enough that the attended rows matter).
"""

from __future__ import annotations

import math

import torch

LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
           "down_proj")
# RMS of a code uniform over the 15 values -7..7
CODE_RMS = math.sqrt(2 * sum(i * i for i in range(1, 8)) / 15)


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg[
        "num_attention_heads"]


def has_bias(cfg: dict) -> bool:
    return cfg.get("attention_bias", cfg["model_type"] == "qwen2")


def has_qk_norm(cfg: dict) -> bool:
    return cfg["model_type"] == "qwen3"


def linear_shapes(cfg: dict) -> dict:
    """(out, in) features of each decoder linear."""
    hid, inter, d = cfg["hidden_size"], cfg["intermediate_size"], head_dim(cfg)
    q, kv = cfg["num_attention_heads"] * d, cfg["num_key_value_heads"] * d
    return {"q_proj": (q, hid), "k_proj": (kv, hid), "v_proj": (kv, hid),
            "o_proj": (hid, q), "gate_proj": (inter, hid),
            "up_proj": (inter, hid), "down_proj": (hid, inter)}


def _words(gen, layers, n, k, device):
    """(layers, n, k/8) int32 pack-quantized words: 8 codes a word, code j
    in bits 4j..4j+3 offset by +8; each byte holds two nibbles in 1..15."""
    r = torch.randint(0, 225, (layers, n, k // 2), generator=gen,
                      device=device, dtype=torch.uint8)
    lo = r % 15 + 1
    hi = r // 15 + 1
    del r
    return (lo | (hi << 4)).view(torch.int32)


def draw(cfg: dict, seed: int, device) -> dict:
    """The model's checkpoint-layout tensors drawn from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    quant = cfg["quantization"]
    g = quant["group_size"]
    opts = cfg["draw"]
    L, hid, vocab = (cfg["num_hidden_layers"], cfg["hidden_size"],
                     cfg["vocab_size"])
    d = head_dim(cfg)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=bf16)

    def near_one(*shape, spread=opts["norm_spread"], centre=1.0):
        return (centre * (1 + spread * torch.randn(
            shape, generator=gen, device=device))).to(bf16)

    raw = {"embed": randn(vocab, hid).mul_(opts["embed_std"])}
    layers = {"input_layernorm": near_one(L, hid),
              "post_attention_layernorm": near_one(L, hid)}
    if has_qk_norm(cfg):
        layers["q_norm"] = near_one(L, d, centre=opts["qk_norm_weight"])
        layers["k_norm"] = near_one(L, d, centre=opts["qk_norm_weight"])
    for name, (n, k) in linear_shapes(cfg).items():
        words = _words(gen, L, n, k, device)
        base = opts["gain"][name] / math.sqrt(k) / CODE_RMS
        scales = ((torch.rand((L, n, k // g), generator=gen, device=device)
                   * 0.5 + 0.75) * base).to(bf16)
        bias = None
        if has_bias(cfg) and name in ("q_proj", "k_proj", "v_proj"):
            bias = randn(L, n).mul_(opts["bias_std"])
        layers[name] = {"words": words, "scales": scales, "bias": bias,
                        "shape": (n, k)}
    raw["layers"] = layers
    raw["norm"] = near_one(hid)
    raw["lm_head"] = randn(vocab, hid).mul_(opts["logit_std"]
                                            / math.sqrt(hid))
    return raw


def serve_params(raw: dict, cfg: dict):
    """The port's params over the drawn tensors, as its loader builds them
    from a checkpoint (``QuantizedTensor`` per linear, the kernel layout,
    q/k/v and gate/up fused), and its ``LlamaConfig``."""
    from compressed_tensors_tpu_torch.models.config import LlamaConfig
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers
    from compressed_tensors_tpu_torch.ops.linear import (
        QuantizedTensor,
        prepare_for_kernels,
    )
    from compressed_tensors_tpu_torch.quantization import (
        preset_name_to_scheme,
    )

    quant = cfg["quantization"]
    scheme = preset_name_to_scheme(quant["scheme"], ["Linear"])
    scheme.format = quant["format"]
    if (scheme.weights.group_size != quant["group_size"]
            or scheme.weights.num_bits != 4 or not scheme.weights.symmetric):
        raise ValueError(f"{quant['scheme']} is not symmetric W4 group "
                         f"{quant['group_size']}")
    src = raw["layers"]
    layers = []
    for i in range(cfg["num_hidden_layers"]):
        layer = {}
        for name in LINEARS:
            lin = src[name]
            bias = lin["bias"][i] if lin["bias"] is not None else None
            layer[name] = prepare_for_kernels(QuantizedTensor(
                weight_packed=lin["words"][i], scale=lin["scales"][i],
                bias=bias, shape=lin["shape"], scheme=scheme,
                format=scheme.format))
        for name in ("input_layernorm", "post_attention_layernorm", "q_norm",
                     "k_norm"):
            if name in src:
                layer[name] = src[name][i]
        layers.append(layer)
    params = {"embed_tokens": raw["embed"], "norm": raw["norm"],
              "lm_head": raw["lm_head"], "layers": layers}
    return fuse_llama_layers(params), LlamaConfig.from_dict(cfg)
