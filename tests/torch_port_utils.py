"""Helpers for the parity tests of compressed_tensors_tpu_torch against the
JAX package: numpy bridges for parameters, and the small model shared by
the slice tests."""

import numpy as np
import torch

# 2 layers, hidden 256, intermediate 512, 8 heads / 2 KV heads, head_dim
# 32, vocab 512: the smallest Llama whose widths group size 128 divides
TORCH_TINY_CONFIG = {
    "architectures": ["LlamaForCausalLM"],
    "model_type": "llama",
    "vocab_size": 512,
    "hidden_size": 256,
    "intermediate_size": 512,
    "num_hidden_layers": 2,
    "num_attention_heads": 8,
    "num_key_value_heads": 2,
    "head_dim": 32,
    "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0,
    "max_position_embeddings": 512,
    "tie_word_embeddings": False,
}


def w4a16_config(symmetric=True, group_size=128):
    return {
        "config_groups": {"group_0": {
            "targets": ["Linear"],
            "weights": {"num_bits": 4, "type": "int",
                        "symmetric": symmetric, "strategy": "group",
                        "group_size": group_size},
            "format": "pack-quantized"}},
        "format": "pack-quantized",
        "ignore": ["lm_head"],
        "quant_method": "compressed-tensors",
        "quantization_status": "compressed",
    }


def preset_config(preset, fmt):
    """A checkpoint quantization config: ``preset`` on every Linear but the
    lm_head, stored in format ``fmt``."""
    return {"config_groups": {preset: ["Linear"]}, "format": fmt,
            "ignore": ["lm_head"], "quant_method": "compressed-tensors",
            "quantization_status": "compressed"}


def make_tiny_fp4_checkpoint(tmp_path, rng, preset="NVFP4A16",
                             fmt="nvfp4-pack-quantized",
                             model_config=None, fused_global=False):
    """A random tiny Llama checkpoint in an FP4 format, quantized and
    compressed by the JAX package. NVFP4 global scales are per tensor, or
    with ``fused_global`` one per fused group (q/k/v, gate/up), as
    checkpoints made for fused loading carry them. Returns the directory.
    (``testing_utils.make_tiny_llama_checkpoint`` computes no global
    scale.)"""
    import json
    import os

    import jax.numpy as jnp

    from compressed_tensors_tpu.compressors import (
        ModelCompressor,
        module_graph_from_names,
    )
    from compressed_tensors_tpu.ops import calculate_qparams
    from compressed_tensors_tpu.ops.qparams import generate_gparam
    from compressed_tensors_tpu.quantization import preset_name_to_scheme

    cfg = dict(model_config or TORCH_TINY_CONFIG)
    H, I, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    NH, KVH, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    shapes = {"model.embed_tokens": (V, H)}
    extra = {"model.norm.weight": np.ones(H, np.float32)}
    fused = []
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        attn = {f"{p}.self_attn.{n}_proj": (rows, H) for n, rows in
                (("q", NH * D), ("k", KVH * D), ("v", KVH * D))}
        mlp = {f"{p}.mlp.{n}_proj": (I, H) for n in ("gate", "up")}
        shapes.update(attn)
        shapes[f"{p}.self_attn.o_proj"] = (H, NH * D)
        shapes.update(mlp)
        shapes[f"{p}.mlp.down_proj"] = (H, I)
        fused += [list(attn), list(mlp)]
        for norm in ("input_layernorm", "post_attention_layernorm"):
            extra[f"{p}.{norm}.weight"] = np.ones(H, np.float32)
    shapes["lm_head"] = (V, H)
    weights = {name: (rng.normal(size=shape) * 0.05).astype(np.float32)
               for name, shape in shapes.items()}
    groups = {name: [name] for name in shapes}
    if fused_global:
        groups.update({name: members for members in fused
                       for name in members})

    args = preset_name_to_scheme(preset, ["Linear"]).weights
    states = {}
    for name, w in weights.items():
        states[name] = {"weight": jnp.asarray(w)}
        if name in ("model.embed_tokens", "lm_head"):
            continue
        global_scale = None
        if preset.startswith("NVFP4"):
            members = np.concatenate([weights[m] for m in groups[name]])
            global_scale = generate_gparam(jnp.asarray(members.min()),
                                           jnp.asarray(members.max()))
            states[name]["weight_global_scale"] = global_scale
        g = w.reshape(w.shape[0], -1, args.group_size)
        states[name]["weight_scale"], _ = calculate_qparams(
            jnp.asarray(g.min(-1)), jnp.asarray(g.max(-1)), args,
            global_scale=global_scale)

    save_dir = str(tmp_path / "tiny_fp4")
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(cfg, f)
    mc = ModelCompressor.from_compression_config(preset_config(preset, fmt))
    mc.save_checkpoint(save_dir, states, module_graph_from_names(list(shapes)),
                       extra_tensors=extra)
    return save_dir


def fp8_dynamic_config():
    """FP8_DYNAMIC: per-channel fp8 e4m3 weights, dynamic per-token fp8
    activations, bf16 lm_head."""
    return {
        "config_groups": {"group_0": {
            "targets": ["Linear"],
            "weights": {"num_bits": 8, "type": "float", "symmetric": True,
                        "strategy": "channel"},
            "input_activations": {"num_bits": 8, "type": "float",
                                  "symmetric": True, "strategy": "token",
                                  "dynamic": True}}},
        "format": "float-quantized",
        "ignore": ["lm_head"],
        "quant_method": "compressed-tensors",
        "quantization_status": "frozen",
    }


def raw_bytes(t) -> np.ndarray:
    """A torch tensor or JAX array as numpy, 1-byte floats as their uint8
    bits (for bit-for-bit cache comparisons)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype.is_floating_point and t.dtype.itemsize == 1:
            t = t.view(torch.uint8)
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.uint8) if a.dtype.name.startswith("float8") else a


_VIEWS = {"bfloat16": (np.uint16, torch.bfloat16),
          "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def to_torch(a) -> torch.Tensor:
    """numpy/JAX array -> torch tensor (bf16 and fp8 through an integer
    view of the same bytes)."""
    a = np.array(a)
    if a.dtype.name in _VIEWS:
        view, dtype = _VIEWS[a.dtype.name]
        return torch.from_numpy(a.view(view)).view(dtype)
    return torch.from_numpy(a)


def to_numpy(t) -> np.ndarray:
    """torch tensor or JAX array -> f32 (floats) or integer numpy array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.kind == "V" or \
        a.dtype.name == "bfloat16" else a


_LINEAR_FIELDS = ("weight", "weight_packed", "scale", "zero_point", "bias",
                  "g_idx", "global_scale", "input_global_scale")


def jax_params_to_numpy(params):
    """The JAX params tree with every leaf in numpy; each QuantizedTensor
    becomes a dict of its checkpoint-layout fields (kernel layouts are
    dropped)."""
    from compressed_tensors_tpu.ops.linear import QuantizedTensor

    if isinstance(params, QuantizedTensor):
        out = {"format": params.format, "shape": tuple(params.shape),
               "scheme": (params.scheme.model_dump()
                          if params.scheme is not None else None)}
        for f in _LINEAR_FIELDS:
            v = getattr(params, f)
            out[f] = None if v is None else np.asarray(v)
        return out
    if isinstance(params, dict):
        return {k: jax_params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, list):
        return [jax_params_to_numpy(v) for v in params]
    return np.asarray(params)
