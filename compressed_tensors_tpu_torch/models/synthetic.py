"""Synthetic compressed Llama models, and a writer that saves one as a
compressed-tensors checkpoint.

Counterpart of ``compressed_tensors_tpu/models/synthetic.py``. Weights are
drawn with numpy from ``seed`` in the same order and with the same
distributions as the JAX package, directly in their packed
representation, so both packages build the same model from the same seed
(per-layer mixed schemes included). ``sparsity="2:4"``, which the JAX
package's builder lacks, masks the same draw to 2:4 and stores it as the
stacked sparse-24-bitmask state. MoE layers draw their router and their
experts stacked (E, N, K), in the JAX package's order.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from compressed_tensors_tpu_torch.config import CompressionFormat
from compressed_tensors_tpu_torch.models.config import LlamaConfig
from compressed_tensors_tpu_torch.models.llama import resolve_device
from compressed_tensors_tpu_torch.models.mla import mla_rope_perms
from compressed_tensors_tpu_torch.ops.linear import (
    QuantizedTensor,
    expert_slice,
    permute_output_rows,
    prepare_for_kernels,
)
from compressed_tensors_tpu_torch.ops.bitmask import sparse24_compress
from compressed_tensors_tpu_torch.ops.pack import (
    packed_cols,
    unpack_from_int32,
)
from compressed_tensors_tpu_torch.quantization import (
    QuantizationConfig,
    QuantizationScheme,
    QuantizationStatus,
    preset_name_to_scheme,
)
from compressed_tensors_tpu_torch.utils.safetensors_io import save_safetensors

__all__ = ["make_synthetic_llama", "save_llama_checkpoint", "TINYLLAMA_1_1B",
           "LLAMA3_8B"]

TINYLLAMA_1_1B = LlamaConfig(
    vocab_size=32000, hidden_size=2048, intermediate_size=5632,
    num_hidden_layers=22, num_attention_heads=32, num_key_value_heads=4,
    head_dim=64, rope_theta=10000.0, max_position_embeddings=2048,
)

LLAMA3_8B = LlamaConfig(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    head_dim=128, rope_theta=500000.0, max_position_embeddings=8192,
)


def _synthetic_qt(rng: np.random.Generator, shape, scheme: QuantizationScheme,
                  dtype, device) -> QuantizedTensor:
    """Random compressed weight for `shape` (dense, pack-quantized, int8 or
    fp8 e4m3); a leading dim (E, N, K) stacks MoE experts."""
    *lead, n, k = shape
    shape = tuple(shape)
    args = scheme.weights
    if args is None:
        w = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                             * 0.02).to(device=device, dtype=dtype)
        return QuantizedTensor(weight=w, shape=shape, scheme=scheme,
                               format=CompressionFormat.dense.value)
    if args.num_bits == 8 and args.type == "int":
        wq = rng.integers(-127, 128, size=shape, dtype=np.int8)
        scale = rng.uniform(size=(*lead, n, 1)).astype(np.float32) * 2e-4 \
            + 1e-4
        return QuantizedTensor(
            weight=torch.from_numpy(wq).to(device),
            scale=torch.from_numpy(scale).to(device), shape=shape,
            scheme=scheme, format=CompressionFormat.int_quantized.value)
    if args.num_bits == 8 and args.type == "float":
        # N(0, 100^2) clipped inside the e4m3 range (an overflow would cast
        # to NaN), cast on the device with PyTorch's round to nearest even
        w = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            device)
        wq = (w * 100).clamp_(-440, 440).to(torch.float8_e4m3fn)
        del w
        scale = rng.uniform(size=(*lead, n, 1)).astype(np.float32) * 2e-4 \
            + 1e-4
        return QuantizedTensor(
            weight=wq, scale=torch.from_numpy(scale).to(device), shape=shape,
            scheme=scheme, format=CompressionFormat.float_quantized.value)
    if args.type != "int":
        raise NotImplementedError(f"synthetic {args.type} weights")
    g = args.group_size or k
    packed = rng.integers(-(2**31), 2**31,
                          size=(*lead, n, packed_cols(k, args.num_bits)),
                          dtype=np.int32)
    scale = rng.uniform(size=(*lead, n, k // g)).astype(np.float32) * 0.002 \
        + 0.001
    return QuantizedTensor(
        weight_packed=torch.from_numpy(packed).to(device),
        scale=torch.from_numpy(scale).to(device=device, dtype=torch.bfloat16),
        shape=shape, scheme=scheme,
        format=CompressionFormat.pack_quantized.value)


def _sparse24_state(qt: QuantizedTensor) -> QuantizedTensor:
    """A synthetic int weight masked to 2:4 by code magnitude
    (``get_24_bytemasks``) and stored as the stacked sparse state: the
    kept int8 codes and the bitmask beside the scales, as a naive-quantized
    (sub-byte codes) or int-quantized (int8) checkpoint holds them."""
    args = qt.scheme.weights
    codes = (qt.weight if qt.weight_packed is None else
             unpack_from_int32(qt.weight_packed, args.num_bits, qt.shape))
    values, bitmask = sparse24_compress(codes)
    fmt = (CompressionFormat.naive_quantized.value
           if qt.format == CompressionFormat.pack_quantized.value
           else qt.format)
    return QuantizedTensor(scale=qt.scale, zero_point=qt.zero_point,
                           sparse_values=values, sparse_bitmask=bitmask,
                           shape=qt.shape, scheme=qt.scheme, format=fmt)


def make_synthetic_llama(
    config: LlamaConfig,
    preset: str = "W4A16",
    seed: int = 0,
    dtype=torch.bfloat16,
    use_kernels: bool = True,
    layer_presets: list[str] | None = None,
    lm_head_preset: str | None = None,
    sparsity: str | None = None,
    device="cuda",
) -> dict:
    """Build a synthetic compressed Llama params dict on ``device``.

    :param layer_presets: per-layer presets, layer i taking
        ``layer_presets[i % len(layer_presets)]`` (mixed-scheme models,
        BASELINE config 5); ``preset`` otherwise
    :param lm_head_preset: quantize the lm_head with this preset instead of
        tying it to the embedding table
    :param sparsity: "2:4" stores every decoder linear (int schemes only)
        as its draw masked to 2:4 (``_sparse24_state``); the lm_head stays
        dense
    :param use_kernels: build the kernel weight layouts
    """
    device = resolve_device(device)
    if sparsity not in (None, "2:4"):
        raise ValueError(f"sparsity={sparsity!r}")
    H, I, V = config.hidden_size, config.intermediate_size, config.vocab_size
    NH, KVH, D = (config.num_attention_heads, config.num_key_value_heads,
                  config.head_dim)
    rng = np.random.default_rng(seed)

    def linear(shape, scheme, sparse=False):
        qt = _synthetic_qt(rng, shape, scheme, dtype, device)
        if sparse:
            if scheme.weights is None or scheme.weights.type != "int":
                raise NotImplementedError(
                    f"2:4 synthetic weights for {scheme.weights}")
            qt = _sparse24_state(qt)
        return prepare_for_kernels(qt) if use_kernels else qt

    params: dict = {
        "embed_tokens": torch.from_numpy(
            rng.standard_normal((V, H), dtype=np.float32) * 0.02).to(
                device=device, dtype=dtype),
        "norm": torch.ones((H,), dtype=dtype, device=device),
        "layers": [],
    }
    sparse = sparsity is not None
    for i in range(config.num_hidden_layers):
        scheme = preset_name_to_scheme(
            layer_presets[i % len(layer_presets)] if layer_presets
            else preset, ["Linear"])
        layer = {
            "q_proj": linear((NH * D, H), scheme, sparse),
            "k_proj": linear((KVH * D, H), scheme, sparse),
            "v_proj": linear((KVH * D, H), scheme, sparse),
            "o_proj": linear((H, NH * D), scheme, sparse),
            "input_layernorm": torch.ones((H,), dtype=dtype, device=device),
            "post_attention_layernorm": torch.ones((H,), dtype=dtype,
                                                   device=device),
        }
        if config.layer_is_moe(i):
            if sparse:
                raise NotImplementedError("2:4 synthetic MoE experts")
            E = config.num_local_experts
            Im = config.moe_intermediate_size or I
            moe: dict = {
                "router": torch.from_numpy(
                    rng.standard_normal((E, H), dtype=np.float32) * 0.02).to(
                        device=device, dtype=dtype),
                "experts": {
                    "gate_proj": linear((E, Im, H), scheme),
                    "up_proj": linear((E, Im, H), scheme),
                    "down_proj": linear((E, H, Im), scheme),
                },
            }
            Is = config.shared_expert_intermediate_size
            if Is:
                moe["shared_expert"] = {
                    "gate_proj": linear((Is, H), scheme),
                    "up_proj": linear((Is, H), scheme),
                    "down_proj": linear((H, Is), scheme),
                }
            layer["moe"] = moe
        else:
            layer["gate_proj"] = linear((I, H), scheme, sparse)
            layer["up_proj"] = linear((I, H), scheme, sparse)
            layer["down_proj"] = linear((H, I), scheme, sparse)
        params["layers"].append(layer)
    if lm_head_preset is not None:
        params["lm_head"] = linear(
            (V, H), preset_name_to_scheme(lm_head_preset, ["lm_head"]))
    else:
        params["lm_head"] = params["embed_tokens"]
    return params


def _checkpoint_state(qt: QuantizedTensor) -> dict[str, torch.Tensor]:
    """The checkpoint-layout tensors of one linear (kernel layout dropped)."""
    state = {}
    if qt.sparse_values is not None:
        state["weight.compressed"] = qt.sparse_values
        state["weight.bitmask"] = qt.sparse_bitmask
        state["weight.shape"] = torch.tensor(qt.shape, dtype=torch.int32)
    if qt.weight_packed is not None:
        state["weight_packed"] = qt.weight_packed
        if qt.format == CompressionFormat.pack_quantized.value:
            state["weight_shape"] = torch.tensor(qt.shape, dtype=torch.int32)
    if qt.weight is not None:
        state["weight"] = qt.weight
    for local, field in (("weight_scale", "scale"),
                         ("weight_zero_point", "zero_point"),
                         ("weight_g_idx", "g_idx"),
                         ("weight_global_scale", "global_scale"),
                         ("input_global_scale", "input_global_scale"),
                         ("bias", "bias")):
        if getattr(qt, field) is not None:
            state[local] = getattr(qt, field)
    return state


def _mla_linears(layer: dict, config: LlamaConfig, prefix: str
                 ) -> dict[str, QuantizedTensor]:
    """An MLA layer's attention linears by checkpoint name, the rope rows
    of ``kv_a_proj_with_mqa`` and of the q projection permuted back to
    the interleaved order (kernel layouts dropped first: the permutation
    reads the checkpoint layout)."""
    perms = mla_rope_perms(config)
    out = {}
    for proj in ("q_proj", "q_a_proj", "q_b_proj", "kv_a_proj_with_mqa",
                 "kv_b_proj", "o_proj"):
        qt = layer.get(proj)
        if qt is None:
            continue
        if proj in perms:
            qt = permute_output_rows(dataclasses.replace(
                qt, kernel_packed=None, kernel_scales=None, kernel_zp=None,
                kernel_perm=None, kernel_meta=None),
                torch.argsort(perms[proj]))
        out[f"{prefix}.self_attn.{proj}"] = qt
    return out


def _layer_target(names: list[str]) -> list[str]:
    """Targets naming exactly these modules' layers (and the lm_head among
    them): one ``re:`` over the layer indices."""
    layers = sorted({int(n.split(".")[2]) for n in names
                     if n.startswith("model.layers.")})
    targets = ([r"re:model\.layers\.(" + "|".join(map(str, layers))
                + r")\."] if layers else [])
    return targets + (["lm_head"] if "lm_head" in names else [])


def save_llama_checkpoint(params: dict, config: LlamaConfig, path: str) -> None:
    """Write unfused Llama params as a compressed-tensors checkpoint:
    ``model.safetensors`` plus ``config.json`` with its
    ``quantization_config``: one config group per distinct scheme (the
    linears stored dense, such as an unquantized lm_head, in its
    ``ignore``), each with its scheme's targets (the lm_head's
    ``lm_head``) where the decoder layers share one scheme, and ``re:``
    targets over their layer
    indices where they mix several. 2:4 sparse linears are written as
    ``weight.compressed`` / ``weight.bitmask`` / ``weight.shape`` under a
    ``sparsity_config`` (sparse-24-bitmask, ignoring the linears stored
    dense). Per-layer ``k_scale``/``v_scale``/``q_scale`` and the Qwen3
    ``q_norm``/``k_norm`` weights are written under
    ``model.layers.{i}.self_attn.``. MoE layers are written in the Qwen
    naming, one 2-D linear per expert
    (``mlp.experts.{j}.{gate,up,down}_proj``), the router as
    ``mlp.gate.weight`` and a shared expert as ``mlp.shared_expert.*``;
    ``config.json`` then names the MoE widths (and ``model_type``
    qwen3_moe for models with q/k norms).

    MLA models (``config.is_mla``) are written as DeepSeek V2 checkpoints
    (``model_type`` deepseek_v2, the shared expert as
    ``mlp.shared_experts.*``): ``q_proj`` or ``q_a_proj`` /
    ``q_a_layernorm`` / ``q_b_proj``, ``kv_a_proj_with_mqa``,
    ``kv_a_layernorm``, ``kv_b_proj`` and ``o_proj``, with the rope rows of
    ``kv_a_proj_with_mqa`` and of the q projection back in DeepSeek's
    interleaved order (the inverse of the loader's ``mla_rope_perms``), so
    that the loader's permutation restores the params' own rows."""
    os.makedirs(path, exist_ok=True)
    tensors: dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": params["embed_tokens"],
        "model.norm.weight": params["norm"],
    }
    linears: dict[str, QuantizedTensor] = {}
    shared_name = "shared_experts" if config.is_mla else "shared_expert"
    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}"
        if config.is_mla:
            linears.update(_mla_linears(layer, config, p))
            for norm in ("q_a_layernorm", "kv_a_layernorm"):
                if layer.get(norm) is not None:
                    tensors[f"{p}.self_attn.{norm}.weight"] = layer[norm]
        else:
            for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
                linears[f"{p}.self_attn.{proj}"] = layer[proj]
        moe = layer.get("moe")
        if moe is not None:
            tensors[f"{p}.mlp.gate.weight"] = moe["router"]
            for proj, qt in moe["experts"].items():
                for e in range(qt.shape[0]):
                    linears[f"{p}.mlp.experts.{e}.{proj}"] = expert_slice(
                        qt, e)
            for proj, qt in (moe.get("shared_expert") or {}).items():
                linears[f"{p}.mlp.{shared_name}.{proj}"] = qt
        else:
            for proj in ("gate_proj", "up_proj", "down_proj"):
                linears[f"{p}.mlp.{proj}"] = layer[proj]
        for norm in ("input_layernorm", "post_attention_layernorm"):
            tensors[f"{p}.{norm}.weight"] = layer[norm]
        for sname in ("k_scale", "v_scale", "q_scale"):
            if layer.get(sname) is not None:
                tensors[f"{p}.self_attn.{sname}"] = layer[sname]
        for nname in ("q_norm", "k_norm"):
            if layer.get(nname) is not None:
                tensors[f"{p}.self_attn.{nname}.weight"] = layer[nname]
    if isinstance(params["lm_head"], QuantizedTensor):
        linears["lm_head"] = params["lm_head"]

    members: list[tuple[QuantizationScheme, list[str]]] = []
    formats = set()
    unquantized = []  # dense linears, which the config groups must ignore
    for name, qt in linears.items():
        for local, t in _checkpoint_state(qt).items():
            tensors[f"{name}.{local}"] = t
        if qt.scheme is None or qt.scheme.weights is None:
            unquantized.append(name)
            continue
        scheme = qt.scheme.model_copy(update={"format": qt.format})
        formats.add(qt.format)
        for known, names in members:
            if known == scheme:
                names.append(name)
                break
        else:
            members.append((scheme, [name]))
    mixed = sum(any(n != "lm_head" for n in names)
                for _, names in members) > 1
    groups = {f"group_{i}": (scheme.model_copy(
                  update={"targets": _layer_target(names)}) if mixed
                  else scheme)
              for i, (scheme, names) in enumerate(members)}
    save_safetensors(os.path.join(path, "model.safetensors"), tensors,
                     metadata={"format": "pt"})

    model_type = ("qwen3_moe" if config.is_moe else "qwen3") \
        if config.qk_norm else "llama"
    if config.is_mla:
        model_type = "deepseek_v2"
    cfg = {
        "architectures": ["LlamaForCausalLM"], "model_type": model_type,
        "attention_bias": config.attention_bias,
        "vocab_size": config.vocab_size, "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "num_hidden_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "num_key_value_heads": config.num_key_value_heads,
        "head_dim": config.head_dim, "rms_norm_eps": config.rms_norm_eps,
        "rope_theta": config.rope_theta,
        "max_position_embeddings": config.max_position_embeddings,
        "tie_word_embeddings": not isinstance(params["lm_head"],
                                              QuantizedTensor),
    }
    if config.is_moe:
        cfg.update(num_experts=config.num_local_experts,
                   num_experts_per_tok=config.num_experts_per_tok,
                   moe_intermediate_size=config.moe_intermediate_size,
                   shared_expert_intermediate_size=(
                       config.shared_expert_intermediate_size),
                   first_k_dense_replace=config.first_k_dense_replace,
                   norm_topk_prob=config.norm_topk_prob)
    if config.is_mla:
        cfg.update(q_lora_rank=config.q_lora_rank or None,
                   kv_lora_rank=config.kv_lora_rank,
                   qk_nope_head_dim=config.qk_nope_head_dim,
                   qk_rope_head_dim=config.qk_rope_head_dim,
                   v_head_dim=config.v_head_dim)
    if groups:
        qconfig = QuantizationConfig(
            config_groups=groups,
            format=(formats.pop() if len(formats) == 1
                    else CompressionFormat.mixed_precision.value),
            quantization_status=QuantizationStatus.COMPRESSED,
            ignore=unquantized,
        )
        cfg["quantization_config"] = qconfig.model_dump(mode="json")
        dense = [n for n, qt in linears.items() if qt.sparse_values is None]
        if len(dense) < len(linears):
            cfg["quantization_config"]["sparsity_config"] = {
                "format": CompressionFormat.sparse_24_bitmask.value,
                "targets": ["Linear"], "ignore": dense,
                "sparsity_structure": "2:4"}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
