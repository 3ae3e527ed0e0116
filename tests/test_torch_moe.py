"""MoE in the PyTorch port against the JAX package, in f32 on the CPU:
``moe_capacity``, ``_route``, ``moe_mlp`` (with and without dropped
slots), ``quantized_matmul_experts`` in every branch, the synthetic MoE
draw, MoE checkpoints in the Qwen, Mixtral and DeepSeek (``shared_experts``)
naming loaded by both packages, and the serving engine on an MoE model.

The port's kernel path runs the expert-batched kernels' plain versions
(CPU tensors), its non-kernel path the JAX package's arithmetic. Both are
held to the JAX non-kernel path within 1e-4 * max|y| for one matmul or
one MoE block and 1e-3 * max|logits| for a model, the tolerances of the
other port tests (f32 summation order; routing is identical, since the
router runs the same f32 product). W8A8-int and FP8 experts round their
activations per token: one f32 ulp apart on a rounding boundary moves an
activation by a step, so they are held to 1e-2 * max|y| as in
``tests/test_torch_mixed.py``."""

import dataclasses
import functools
import json
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from compressed_tensors_tpu.engine import greedy_generate as j_generate
from compressed_tensors_tpu.engine import (
    Request as JRequest,
    ServingEngine as JEngine,
)
from compressed_tensors_tpu.flags import flag_overrides as j_flags
from compressed_tensors_tpu.models import llama as jl
from compressed_tensors_tpu.models import moe as jmoe
from compressed_tensors_tpu.models.config import LlamaConfig as JConfig
from compressed_tensors_tpu.models.synthetic import (
    _synthetic_qt as j_synthetic_qt,
    make_synthetic_llama as j_synthetic,
)
from compressed_tensors_tpu.ops.linear import (
    QuantizedTensor as JQT,
    prepare_experts_for_kernels as j_prepare_experts,
    quantized_matmul_experts as j_matmul_experts,
)
from compressed_tensors_tpu.ops.pack import pack_to_int32 as j_pack
from compressed_tensors_tpu.quantization import (
    preset_name_to_scheme as j_preset,
)
from testing_utils import make_tiny_llama_checkpoint

from compressed_tensors_tpu_torch.engine import (
    Request,
    ServingEngine,
    greedy_generate,
)
from compressed_tensors_tpu_torch.flags import flag_overrides
from compressed_tensors_tpu_torch.interop import params_from_numpy
from compressed_tensors_tpu_torch.models import llama as tl
from compressed_tensors_tpu_torch.models import moe as tmoe
from compressed_tensors_tpu_torch.models.config import LlamaConfig
from compressed_tensors_tpu_torch.models.synthetic import (
    make_synthetic_llama,
    save_llama_checkpoint,
)
from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers
from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as kw
from compressed_tensors_tpu_torch.ops.linear import (
    QuantizedTensor,
    prepare_experts_for_kernels,
    quantized_matmul_experts,
    stack_quantized_tensors,
)

from torch_port_utils import jax_params_to_numpy, to_numpy, w4a16_config

# hidden 128 (one W4A16 group), 4 experts, top 2: the JAX MoE test's model
MOE = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           head_dim=32, num_local_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=128)
INT8_ACTS = 1e-2  # a W8A8 expert against the JAX package: one int8 step


def _close(got, want, rel=1e-4):
    want = to_numpy(want)
    np.testing.assert_allclose(to_numpy(got), want,
                               atol=rel * np.abs(want).max(), rtol=0)


def _ids(B, S, seed=1, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S))


# (tokens, experts, top k, capacity factor): the JAX test's cases, the
# Qwen3-30B-A3B call shapes (decode batch 64, a 512-row serving chunk, a
# 64 x 128-token prefill), and small ragged ones
CAPACITY_CASES = [(64, 4, 2, 1.0), (1, 8, 2, 1.25), (64, 4, 2, 1.25),
                  (16, 4, 2, 1.25), (7, 3, 2, 4.0), (100, 8, 2, 1.0),
                  (64, 128, 8, 1.25), (300, 128, 8, 1.25),
                  (512, 128, 8, 1.25), (8192, 128, 8, 1.25),
                  (3, 128, 8, 1.25), (1000, 8, 2, 1.25)]


@pytest.mark.parametrize("case", CAPACITY_CASES)
def test_moe_capacity_matches_jax(case):
    assert tmoe.moe_capacity(*case) == jmoe.moe_capacity(*case)
    assert tmoe.moe_capacity(*case) % 8 == 0


@pytest.mark.parametrize("norm", [True, False])
def test_route_matches_jax(norm):
    rng = np.random.default_rng(0)
    tokens = rng.standard_normal((40, 128)).astype(np.float32)
    router = (rng.standard_normal((8, 128)) * 0.2).astype(np.float32)
    config = dict(MOE, num_local_experts=8, num_experts_per_tok=3,
                  norm_topk_prob=norm)
    jw, ji = jmoe._route(jnp.asarray(tokens), jnp.asarray(router),
                         JConfig(**config))
    tw, ti = tmoe._route(torch.from_numpy(tokens), torch.from_numpy(router),
                         LlamaConfig(**config))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)


def _f32_scales(tree):
    """The JAX params with every linear's bf16 scales as f32 (the same
    values): the JAX non-kernel path dequantizes in the scale's dtype, the
    port's kernels in f32."""
    if isinstance(tree, JQT):
        return (dataclasses.replace(tree, scale=tree.scale.astype(jnp.float32))
                if tree.scale is not None else tree)
    if isinstance(tree, dict):
        return {k: _f32_scales(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32_scales(v) for v in tree]
    return tree


def _layer_pair(preset="W4A16", seed=0, **cfg):
    """Layer 0 of the JAX synthetic MoE draw (f32 scales) and the port's
    copy of it, with the port's kernel layouts."""
    config = dict(MOE, **cfg)
    jp = _f32_scales(j_synthetic(JConfig(**config), preset=preset, seed=seed,
                                 use_kernels=False, dtype=jnp.float32))
    tp = params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    return jp["layers"][0], tp["layers"][0], config


def _skewed_tokens(jlayer, seed, T=64):
    """Tokens three quarters of which lean toward expert 0's router row (a
    common component), so that expert 0 overflows its capacity at factor
    1.25."""
    rng = np.random.default_rng(seed)
    router = np.asarray(jlayer["moe"]["router"], np.float32)
    x = rng.standard_normal((T, router.shape[1])).astype(np.float32) * 0.5
    x[:3 * T // 4] += 40.0 * router[0] / np.linalg.norm(router[0])
    return x.reshape(2, T // 2, -1)


def _dropped(jlayer, x, config, factor):
    """Slots at or past their expert's capacity."""
    tokens = jnp.asarray(x.reshape(-1, x.shape[-1]))
    _, top_i = jmoe._route(tokens, jlayer["moe"]["router"], JConfig(**config))
    counts = np.bincount(np.asarray(top_i).reshape(-1),
                         minlength=config["num_local_experts"])
    cap = jmoe.moe_capacity(tokens.shape[0], config["num_local_experts"],
                            config["num_experts_per_tok"], factor)
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("factor", [1.25, 4.0])
@pytest.mark.parametrize("preset", ["W4A16", "UNQUANTIZED"])
def test_moe_mlp_matches_jax(preset, factor):
    """The routed block at capacity factor 1.25 (skewed tokens: slots are
    dropped) and 4.0 (none are), the port's kernel path (the B1e plain
    version) and its non-kernel path against the JAX block."""
    jlayer, tlayer, config = _layer_pair(preset)
    x = _skewed_tokens(jlayer, 1)
    dropped = _dropped(jlayer, x, config, factor)
    assert (dropped > 0) == (factor == 1.25), dropped
    want = jmoe.moe_mlp(jlayer, jnp.asarray(x), JConfig(**config),
                        capacity_factor=factor)
    if preset == "W4A16":
        assert tlayer["moe"]["experts"]["gate_proj"].kernel_meta[0] == "w4a16"
    for use_kernels in (True, False):
        got = tmoe.moe_mlp(tlayer, torch.from_numpy(x), LlamaConfig(**config),
                           capacity_factor=factor, use_kernels=use_kernels)
        _close(got, want)


def _stacked(preset, shape, seed=0, fmt=None):
    """A stacked expert weight drawn by the JAX package, and the port's
    copy (checkpoint layout)."""
    scheme = j_preset(preset, ["Linear"])
    if fmt is not None:
        scheme.format = fmt
    jqt = _f32_scales(j_synthetic_qt(np.random.default_rng(seed), shape,
                                     scheme, jnp.float32, use_kernels=False))
    tree = jax_params_to_numpy({"w": jqt})
    return jqt, params_from_numpy(tree, device="cpu", use_kernels=False)["w"]


def _experts_case(jqt, tqt, x, kind, rel=1e-4):
    want = j_matmul_experts(jnp.asarray(x), jqt)
    tk = prepare_experts_for_kernels(tqt)
    assert (tk.kernel_meta[0] if tk.kernel_meta else None) == kind
    tx = torch.from_numpy(x)
    _close(quantized_matmul_experts(tx, tk), want, rel)
    _close(quantized_matmul_experts(tx, tk, use_kernels=False), want, rel)
    _close(quantized_matmul_experts(tx, tqt), want, rel)


def _asym_w4(seed, shape):
    """W4A16_ASYM stacked experts in checkpoint layout (random words,
    zero points in [-8, 7] packed along the row dim)."""
    rng = np.random.default_rng(seed)
    E, n, k = shape
    scheme = j_preset("W4A16_ASYM", ["Linear"])
    scheme.format = "pack-quantized"
    zp = rng.integers(-8, 8, (E, n, k // 128)).astype(np.int8)
    jqt = JQT(
        weight_packed=jnp.asarray(rng.integers(-(2**31), 2**31,
                                               (E, n, k // 8), np.int32)),
        scale=jnp.asarray(rng.uniform(1e-3, 3e-3, (E, n, k // 128)).astype(
            np.float32)),
        zero_point=jnp.stack([j_pack(jnp.asarray(z), 4, packed_dim=0)
                              for z in zp]),
        shape=shape, scheme=scheme, format="pack-quantized")
    tree = jax_params_to_numpy({"w": jqt})
    return jqt, params_from_numpy(tree, device="cpu", use_kernels=False)["w"]


@pytest.mark.parametrize("asym", [False, True])
def test_experts_w4a16_matches_jax(asym):
    """Stacked W4A16 experts (symmetric, and with zero points) through
    B1e's plain version, at decode and prefill row counts per expert."""
    shape = (4, 256, 384)
    jqt, tqt = (_asym_w4(1, shape) if asym
                else _stacked("W4A16", shape, seed=1))
    for c in (8, 40):
        x = np.random.default_rng(c).standard_normal((4, c, 384)).astype(
            np.float32)
        _experts_case(jqt, tqt, x, "w4a16")


def test_experts_a8b_matches_jax_interpret():
    """Under w4_act="int8" the B2e plain version against the JAX package's
    vmapped Pallas kernel in interpret mode, at one small shape."""
    jqt, tqt = _stacked("W4A16", (2, 128, 256), seed=2)
    x = np.random.default_rng(3).standard_normal((2, 8, 256)).astype(
        np.float32)
    with j_flags(pallas_interpret=True, w4_act="int8"):
        want = j_matmul_experts(jnp.asarray(x), j_prepare_experts(jqt))
    with flag_overrides(w4_act="int8"):
        got = quantized_matmul_experts(torch.from_numpy(x),
                                       prepare_experts_for_kernels(tqt))
    _close(got, want)
    # the mode changed the arithmetic
    plain = quantized_matmul_experts(torch.from_numpy(x),
                                     prepare_experts_for_kernels(tqt))
    assert not torch.equal(got, plain)


def test_experts_int4b_matches_jax_interpret():
    """B1e's plain version against the JAX vmapped Pallas kernel (mode
    int4b) in interpret mode, at one small shape."""
    jqt, tqt = _stacked("W4A16", (2, 128, 256), seed=4)
    x = np.random.default_rng(5).standard_normal((2, 8, 256)).astype(
        np.float32)
    with j_flags(pallas_interpret=True):
        want = j_matmul_experts(jnp.asarray(x), j_prepare_experts(jqt))
    got = quantized_matmul_experts(torch.from_numpy(x),
                                   prepare_experts_for_kernels(tqt))
    _close(got, want)


@pytest.mark.parametrize("case", ["W8A16", "W4A16-e8"])
def test_experts_w4e8_matches_jax(case):
    """Grouped-int8 experts (W8A16 pack-quantized, and symmetric W4A16
    under w4_layout="e8") through B9e's plain version."""
    if case == "W8A16":
        jqt, tqt = _stacked("W8A16", (3, 256, 256), seed=6,
                            fmt="pack-quantized")
        layout = None
    else:
        jqt, tqt = _stacked("W4A16", (3, 256, 256), seed=6)
        layout = "e8"
    x = np.random.default_rng(7).standard_normal((3, 16, 256)).astype(
        np.float32)
    want = j_matmul_experts(jnp.asarray(x), jqt)
    with flag_overrides(w4_layout=layout or "auto"):
        tk = prepare_experts_for_kernels(tqt)
    assert tk.kernel_meta[0] == "w4e8"
    _close(quantized_matmul_experts(torch.from_numpy(x), tk), want)


@pytest.mark.parametrize("preset", ["W8A8", "FP8_DYNAMIC"])
def test_experts_w8a8_matches_jax(preset):
    """W8A8-int and FP8 experts: the batched per-token-quantized product
    (no kernel layout stacks for them)."""
    jqt, tqt = _stacked(preset, (4, 128, 256), seed=8)
    x = np.random.default_rng(9).standard_normal((4, 16, 256)).astype(
        np.float32)
    _experts_case(jqt, tqt, x, None, INT8_ACTS)


def test_experts_dense_and_bias():
    """Unquantized experts with a bias: dequantize-and-matmul."""
    jqt, tqt = _stacked("UNQUANTIZED", (3, 64, 128), seed=10)
    bias = np.random.default_rng(11).standard_normal((3, 64)).astype(
        np.float32)
    jqt = dataclasses.replace(jqt, bias=jnp.asarray(bias))
    tqt.bias = torch.from_numpy(bias)
    x = np.random.default_rng(12).standard_normal((3, 8, 128)).astype(
        np.float32)
    _experts_case(jqt, tqt, x, None)


@pytest.mark.parametrize("e,c", [(1, 8), (128, 8), (128, 40), (128, 640),
                                 (2, 64)])
def test_expert_plans_count_all_experts(e, c):
    """The expert-batched plans pick the design by C rows and the K split
    from all E experts' blocks: at Qwen3-30B-A3B's gate (N 768, K 2048) one
    expert alone splits K eight ways at decode rows, 128 experts fill the
    card without a split."""
    n, k = 768, 2048
    bm, splits, per = kw.int4b_plan(c, n, k, e)
    assert bm == kw.int4b_plan(c, n, k)[0]
    assert (splits - 1) * per < k // 64 <= splits * per
    if kw.int4b_design(c) == "decode":
        want = max(s for s in (1, 2, 4, 8)
                   if s == 1 or -(-n // 128) * e * s <= 264)
        assert splits == want
        assert kw.wna16_plan(c, n, k, e)[1] == want
    assert kw.a8b_plan(c, n, k, e)[0] <= kw.a8b_plan(c, n, k)[0]


@pytest.mark.parametrize("mode", ["int4b", "a8b"])
def test_expert_plain_versions_stack_the_2d_ones(mode):
    """The expert-batched plain versions (B1e, B2e, B9e) give each expert
    the 2-D plain version's result on that expert's operands."""
    rng = np.random.default_rng(14)
    e, c, n, k, g = 3, 5, 64, 256, 128
    x = torch.from_numpy(rng.standard_normal((e, c, k)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-2**31, 2**31, (e, n, k // 8),
                                      dtype=np.int64).astype(np.int32))
    s = torch.from_numpy(rng.uniform(1e-3, 3e-3, (e, k // g, n)).astype(
        np.float32))
    zp = torch.from_numpy(rng.integers(-8, 8, (e, k // g, n)).astype(
        np.float32))
    w8 = torch.from_numpy(rng.integers(-128, 128, (e, n, k)).astype(np.int8))
    got = kw.w4a16_experts_matmul(x, w, s, zp, n=n, k=k, group_size=g,
                                  mode=mode)
    got8 = kw.w4_e8_experts_matmul(x, w8, s, n=n, k=k, group_size=g)
    for i in range(e):
        _close(got[i], kw.w4a16_matmul_plain(x[i], w[i], s[i], zp[i], n=n,
                                             k=k, group_size=g, mode=mode),
               1e-6)
        _close(got8[i], kw.w4_e8_matmul_plain(x[i], w8[i], s[i], n=n, k=k,
                                              group_size=g), 1e-6)


def test_stack_and_prepare_keep_unstackable_layouts():
    """Stacking keeps every field's leading expert dim; layouts without an
    expert-batched kernel (the plane layout) stay in checkpoint layout."""
    _, tqt = _stacked("W4A16", (2, 128, 256), seed=13)
    singles = [QuantizedTensor(weight_packed=tqt.weight_packed[e],
                               scale=tqt.scale[e], shape=(128, 256),
                               scheme=tqt.scheme, format=tqt.format)
               for e in range(2)]
    st = stack_quantized_tensors(singles)
    assert st.shape == (2, 128, 256)
    assert torch.equal(st.weight_packed, tqt.weight_packed)
    with flag_overrides(w4_layout="packed"):
        assert prepare_experts_for_kernels(tqt).kernel_meta is None


def test_synthetic_moe_draw_matches_jax():
    """make_synthetic_llama draws an MoE model (a leading dense layer, a
    shared expert) weight for weight as the JAX package does."""
    config = dict(MOE, first_k_dense_replace=1,
                  shared_expert_intermediate_size=128)
    jp = j_synthetic(JConfig(**config), seed=3, dtype=jnp.float32,
                     use_kernels=False)
    tp = make_synthetic_llama(LlamaConfig(**config), seed=3,
                              dtype=torch.float32, device="cpu")
    assert "moe" not in tp["layers"][0] and "moe" in tp["layers"][1]
    jm, tm = jp["layers"][1]["moe"], tp["layers"][1]["moe"]
    np.testing.assert_array_equal(tm["router"].numpy(),
                                  np.asarray(jm["router"]))
    for part in ("experts", "shared_expert"):
        for proj in ("gate_proj", "up_proj", "down_proj"):
            a, b = tm[part][proj], jm[part][proj]
            np.testing.assert_array_equal(a.weight_packed.numpy(),
                                          np.asarray(b.weight_packed))
            np.testing.assert_array_equal(to_numpy(a.scale), to_numpy(b.scale))
    assert tm["experts"]["down_proj"].kernel_meta[0] == "w4a16"
    assert tm["experts"]["down_proj"].kernel_packed.shape == (4, 128, 16)
    ids = _ids(2, 8)
    pos = np.broadcast_to(np.arange(8), ids.shape)
    want = jl.llama_forward(jp, JConfig(**config), jnp.asarray(ids),
                            jnp.asarray(pos), use_kernels=False)[0]
    # both non-kernel paths dequantize in the drawn bf16 scales
    got = tl.llama_forward(tp, LlamaConfig(**config), torch.from_numpy(ids),
                           torch.from_numpy(np.array(pos)),
                           use_kernels=False)[0]
    _close(got, want, 1e-3)


def _moe_model_config(**kw):
    cfg = dict(MOE, architectures=["Qwen3MoeForCausalLM"],
               model_type="qwen3_moe", num_experts=4, rms_norm_eps=1e-6,
               rope_theta=10000.0, max_position_embeddings=512,
               norm_topk_prob=True)
    del cfg["num_local_experts"]
    cfg.update(kw)
    return cfg


@pytest.fixture(scope="module")
def moe_checkpoint(tmp_path_factory):
    """A JAX-written W4A16 g128 Qwen3-MoE checkpoint (random q/k norms set
    in the file, so that both packages read them)."""
    path, _ = make_tiny_llama_checkpoint(
        pathlib.Path(tmp_path_factory.mktemp("moe")),
        np.random.default_rng(0), w4a16_config(),
        model_config=_moe_model_config())
    tensors = load_file(os.path.join(path, "model.safetensors"))
    rng = np.random.default_rng(1)
    for name in list(tensors):
        if name.endswith(("q_norm.weight", "k_norm.weight")):
            tensors[name] = (1 + 0.1 * rng.standard_normal(
                tensors[name].shape)).astype(np.float32)
    save_file(tensors, os.path.join(path, "model.safetensors"),
              metadata={"format": "pt"})
    return path


def _both_loaded(path):
    jp, jc, _ = jl.load_llama_params(path, dtype=jnp.float32,
                                     use_kernels=False)
    tp, tc, _ = tl.load_llama_params(path, dtype=torch.float32, device="cpu")
    return jp, jc, tp, tc


def _logits(params, config, ids, package, use_kernels=True):
    pos = np.broadcast_to(np.arange(ids.shape[1]), ids.shape)
    if package == "jax":
        return jl.llama_forward(params, config, jnp.asarray(ids),
                                jnp.asarray(pos), use_kernels=False)[0]
    return tl.llama_forward(params, config, torch.from_numpy(ids),
                            torch.from_numpy(np.array(pos)),
                            use_kernels=use_kernels)[0]


def _model_matches(path, tokens=True):
    jp, jc, tp, tc = _both_loaded(path)
    assert tc.is_moe and tc.qk_norm
    layer = tp["layers"][0]
    assert layer["moe"]["experts"]["up_proj"].kernel_meta[0] == "w4a16"
    ids = _ids(2, 12, seed=2)
    want = _logits(jp, jc, ids, "jax")
    _close(_logits(tp, tc, ids, "torch"), want, 1e-3)
    _close(_logits(tp, tc, ids, "torch", use_kernels=False), want, 1e-3)
    if tokens:
        got = greedy_generate(fuse_llama_layers(tp), tc, ids[:, :8],
                              max_new_tokens=5, dtype=torch.float32,
                              device="cpu").numpy()
        np.testing.assert_array_equal(got, np.asarray(j_generate(
            jp, jc, jnp.asarray(ids[:, :8]), max_new_tokens=5,
            dtype=jnp.float32, use_kernels=False)))
    return tp


def test_moe_checkpoint_matches_jax(moe_checkpoint):
    """The Qwen-named checkpoint: logits and greedy tokens."""
    _model_matches(moe_checkpoint)


def _renamed(src, dst, rename, config_update=None):
    """A copy of checkpoint ``src`` with its tensor names rewritten."""
    os.makedirs(dst, exist_ok=True)
    tensors = load_file(os.path.join(src, "model.safetensors"))
    save_file({rename(k): v for k, v in tensors.items()},
              os.path.join(dst, "model.safetensors"),
              metadata={"format": "pt"})
    with open(os.path.join(src, "config.json")) as f:
        cfg = json.load(f)
    cfg.update(config_update or {})
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(cfg, f)
    return dst


def test_mixtral_naming_matches_jax(moe_checkpoint, tmp_path):
    """The same checkpoint in Mixtral's ``block_sparse_moe`` naming (w1 =
    gate, w3 = up, w2 = down), loaded by both packages."""
    names = {"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}

    def rename(k):
        if ".mlp.experts." in k:
            for src, dst in names.items():
                k = k.replace(f".{src}.", f".{dst}.")
        return k.replace(".mlp.experts.", ".block_sparse_moe.experts.") \
            .replace(".mlp.gate.", ".block_sparse_moe.gate.")

    path = _renamed(moe_checkpoint, str(tmp_path / "mixtral"), rename)
    tp = _model_matches(path, tokens=False)
    assert "moe" in tp["layers"][1]


def test_deepseek_shared_experts_matches_jax(moe_checkpoint, tmp_path):
    """A DeepSeek-named shared expert (``mlp.shared_experts``): expert 3 of
    every layer also written as the layer's always-on expert."""
    tensors = load_file(os.path.join(moe_checkpoint, "model.safetensors"))
    extra = {k.replace(".mlp.experts.3.", ".mlp.shared_experts."): v
             for k, v in tensors.items() if ".mlp.experts.3." in k}
    dst = str(tmp_path / "shared")
    _renamed(moe_checkpoint, dst, lambda k: k)
    save_file({**tensors, **extra}, os.path.join(dst, "model.safetensors"),
              metadata={"format": "pt"})
    jp, jc, tp, tc = _both_loaded(dst)
    assert "shared_expert" in tp["layers"][0]["moe"]
    assert "shared_expert" in jp["layers"][0]["moe"]
    ids = _ids(2, 12, seed=3)
    want = _logits(jp, jc, ids, "jax")
    _close(_logits(tp, tc, ids, "torch"), want, 1e-3)


def test_port_written_moe_checkpoint_loads_in_both(tmp_path):
    """save_llama_checkpoint writes MoE layers one expert at a time in the
    Qwen naming; both loaders read them back into the drawn model."""
    config = LlamaConfig(**dict(MOE, qk_norm=True,
                                shared_expert_intermediate_size=128))
    params = make_synthetic_llama(config, seed=5, dtype=torch.float32,
                                  device="cpu", use_kernels=False)
    for layer in params["layers"]:
        layer["q_norm"] = 1 + 0.1 * torch.randn(32, dtype=torch.float32)
        layer["k_norm"] = torch.ones(32)
        for part in ("experts", "shared_expert"):
            for qt in layer["moe"][part].values():
                qt.scale = qt.scale.to(torch.float32)
    save_llama_checkpoint(params, config, str(tmp_path))
    jp, jc, tp, tc = _both_loaded(str(tmp_path))
    assert tc.is_moe and tc.qk_norm and tc.num_local_experts == 4
    got = tp["layers"][1]["moe"]["experts"]["gate_proj"]
    assert torch.equal(got.weight_packed,
                       params["layers"][1]["moe"]["experts"][
                           "gate_proj"].weight_packed)
    ids = _ids(2, 10, seed=4)
    want = _logits(params, config, ids, "torch", use_kernels=False)
    _close(_logits(tp, tc, ids, "torch"), want, 1e-3)
    _close(_logits(jp, jc, ids, "jax"), want, 1e-3)


def _serve(engine_cls, request_cls, params, config, prompts, new, **kw):
    eng = engine_cls(params, config, **kw)
    for i, p in enumerate(prompts):
        eng.submit(request_cls(request_id=i, prompt_ids=p,
                               max_new_tokens=new))
    return {c.request_id: list(c.output_ids) for c in eng.run()}


def test_serving_moe_paged_dense_and_jax(moe_checkpoint, monkeypatch):
    """The port's ServingEngine on the MoE model: paged equals dense, and
    both equal the JAX engine's completions at a capacity factor where no
    slot is dropped. (Capacity follows a call's row count, and inactive or
    padded rows compete for it; the port's prefill chunks run one row at
    its real length where the JAX engine pads all rows to a bucket, so the
    two engines drop different slots at the default factor.)"""
    jp, jc, tp, tc = _both_loaded(moe_checkpoint)
    tp = fuse_llama_layers(tp)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (5, 17, 9, 3)]
    kw = dict(max_batch=3, max_len=64, prefill_chunk=8)
    dense = _serve(ServingEngine, Request, tp, tc, prompts, 6,
                   dtype=torch.float32, device="cpu", **kw)
    paged = _serve(ServingEngine, Request, tp, tc, prompts, 6, paged=True,
                   page_size=8, dtype=torch.float32, device="cpu", **kw)
    assert dense == paged
    # capacity T*k an expert (factor E = 4): nothing is dropped
    for module in (tmoe, jmoe):
        monkeypatch.setattr(module, "moe_mlp", functools.partial(
            module.moe_mlp, capacity_factor=4.0))
    ours = _serve(ServingEngine, Request, tp, tc, prompts, 6,
                  dtype=torch.float32, device="cpu", **kw)
    theirs = _serve(JEngine, JRequest, jp, jc, prompts, 6,
                    dtype=jnp.float32, use_kernels=False, **kw)
    assert ours == theirs
