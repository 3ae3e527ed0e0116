"""MLA (DeepSeek V2/V3 multi-head latent attention) in the PyTorch port
against the JAX package, in f32 on the CPU.

The model is ``tests/test_models/test_mla.py``'s ``MLA_CONFIG`` (hidden
64, 2 layers, 4 heads, q_lora 32 or none, kv_lora 32, nope 16, rope 8, v
16) written by the JAX package's ``make_tiny_llama_checkpoint``. The JAX
side runs its Pallas kernels in interpret mode, as that test does. The
port's kernel path runs the latent-head decode kernels' plain versions
(CPU tensors) and the absorbed decode; its non-kernel path the
non-absorbed form at every step.

Tolerances: 1e-4 * max|JAX logits| in f32, the other port tests' bound for
one model (f32 summation order; the absorbed and non-absorbed forms are
the same sums in another order). The port's latent caches hold the JAX
package's rows without the lane padding: port K == JAX K[..., :r + rope]
and port V == JAX V[..., :r]. An fp8 or int8 latent cache rounds x / scale
to a code: a latent one f32 ulp apart on the two sides can round to the
neighbouring code, and that step moves the logits by about a code's share
of the attention, so those runs are held to 1e-2 * max|logits| and their
codes to equality but for a few elements one code apart (counted).
"""

import dataclasses
import functools
import json
import os
import pathlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from compressed_tensors_tpu.engine import greedy_generate as j_generate
from compressed_tensors_tpu.engine import (
    Request as JRequest,
    ServingEngine as JEngine,
)
from compressed_tensors_tpu.flags import flag_overrides as j_flags
from compressed_tensors_tpu.models import llama as jl
from compressed_tensors_tpu.models import moe as jmoe
from compressed_tensors_tpu.ops.kernels.decode_attention import (
    decode_attention as j_decode_attention,
)
from compressed_tensors_tpu.ops.kernels.paged_decode import (
    paged_decode_attention as j_paged_decode_attention,
)
from compressed_tensors_tpu.ops.linear import (
    QuantizedTensor as JQT,
    permute_output_rows as j_permute_output_rows,
    prepare_for_kernels as j_prepare_for_kernels,
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
from compressed_tensors_tpu_torch.interop import params_from_numpy
from compressed_tensors_tpu_torch.models import llama as tl
from compressed_tensors_tpu_torch.models import moe as tmoe
from compressed_tensors_tpu_torch.models.config import LlamaConfig
from compressed_tensors_tpu_torch.models.mla import (
    kv_b_weights,
    mla_rope_perms,
)
from compressed_tensors_tpu_torch.models.synthetic import (
    save_llama_checkpoint,
)
from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers
from compressed_tensors_tpu_torch.ops.kernels import (
    decode_attention as tda,
    paged_decode as tpd,
)
from compressed_tensors_tpu_torch.ops.linear import (
    QuantizedTensor,
    permute_output_rows,
    prepare_for_kernels,
)

from torch_port_utils import jax_params_to_numpy, raw_bytes, to_numpy, to_torch

# tests/test_models/test_mla.py's model and scheme
MLA_CONFIG = {
    "model_type": "deepseek_v3", "vocab_size": 256, "hidden_size": 64,
    "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 4, "q_lora_rank": 32,
    "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "rope_theta": 10000.0, "max_position_embeddings": 128,
}
W4A16_G16 = {
    "config_groups": {"group_0": {
        "targets": ["Linear"],
        "weights": {"num_bits": 4, "type": "int", "strategy": "group",
                    "group_size": 16, "symmetric": True}}},
    "format": "pack-quantized", "ignore": ["lm_head"],
    "quant_method": "compressed-tensors",
}
DENSE_CFG = {"config_groups": {}, "format": "dense",
             "quant_method": "compressed-tensors", "ignore": []}
R, ROPE = 32, 8
FP8_STEPS = 1e-2  # logits over an fp8/int8 latent cache (see above)


def _close(got, want, rel=1e-4):
    want = to_numpy(want)
    np.testing.assert_allclose(to_numpy(got), want,
                               atol=rel * np.abs(want).max(), rtol=0)


def _checkpoint(tmp_path, q_lora=32, quant=W4A16_G16, seed=0, **kw):
    cfg = dict(MLA_CONFIG, q_lora_rank=q_lora)
    path, _ = make_tiny_llama_checkpoint(
        pathlib.Path(tmp_path), np.random.default_rng(seed), quant,
        model_config=cfg, **kw)
    return path


def _both_loaded(path):
    jp, jc, _ = jl.load_llama_params(path, dtype=jnp.float32,
                                     use_kernels=False)
    tp, tc, _ = tl.load_llama_params(path, dtype=torch.float32, device="cpu")
    return jp, jc, tp, tc


@pytest.fixture(scope="module")
def mla_checkpoints(tmp_path_factory):
    """The W4A16 g16 MLA checkpoint with and without q_lora."""
    root = tmp_path_factory.mktemp("mla")
    return {q: _checkpoint(root / f"q{q}", q_lora=q) for q in (32, None)}


# ------------------------------------------------------------------ #
# permute_output_rows

def _w4_pair(asym, seed=0, shape=(24, 64), group=16):
    """A W4A16 weight in checkpoint layout for both packages: random
    words, f32 group scales, and for ``asym`` int32 zero points packed
    along the output dim."""
    rng = np.random.default_rng(seed)
    n, k = shape
    scheme = j_preset("W4A16_ASYM" if asym else "W4A16", ["Linear"])
    scheme.weights.group_size = group
    scheme.format = "pack-quantized"
    zp = (j_pack(jnp.asarray(rng.integers(-8, 8, (n, k // group)).astype(
        np.int8)), 4, packed_dim=0) if asym else None)
    jqt = JQT(weight_packed=jnp.asarray(rng.integers(
                  -(2**31), 2**31, (n, k // 8), np.int64).astype(np.int32)),
              scale=jnp.asarray(rng.uniform(1e-3, 3e-3, (n, k // group))
                                .astype(np.float32)),
              zero_point=zp, bias=jnp.asarray(rng.standard_normal(n)
                                               .astype(np.float32)),
              shape=shape, scheme=scheme, format="pack-quantized")
    tqt = params_from_numpy(jax_params_to_numpy({"w": jqt}), device="cpu",
                            use_kernels=False)["w"]
    return jqt, tqt


def _dense_pair(seed=0, shape=(24, 64)):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jqt = JQT(weight=jnp.asarray(w), shape=shape, format="dense")
    return jqt, QuantizedTensor(weight=torch.from_numpy(w), shape=shape,
                                format="dense")


@pytest.mark.parametrize("kind", ["w4", "w4_asym", "dense"])
def test_permute_output_rows_matches_jax(kind):
    """Every leaf bit for bit: words, scales, packed zero points, bias."""
    jqt, tqt = (_dense_pair() if kind == "dense"
                else _w4_pair(asym=kind == "w4_asym"))
    perm = np.random.default_rng(1).permutation(tqt.shape[0])
    want = j_permute_output_rows(jqt, perm)
    got = permute_output_rows(tqt, torch.from_numpy(perm))
    for field in ("weight", "weight_packed", "scale", "zero_point", "bias"):
        w, g = getattr(want, field), getattr(got, field)
        assert (w is None) == (g is None), field
        if w is not None:
            np.testing.assert_array_equal(raw_bytes(g), raw_bytes(w))
    assert got.shape == tqt.shape


def test_permute_output_rows_raises_as_jax():
    """A prepared tensor raises ValueError and a sparse one
    NotImplementedError in both packages; so does a wrong length."""
    jqt, tqt = _w4_pair(asym=False)
    perm = np.arange(tqt.shape[0])
    with pytest.raises(ValueError):
        j_permute_output_rows(jqt, perm[:-1])
    with pytest.raises(ValueError):
        permute_output_rows(tqt, torch.from_numpy(perm[:-1]))
    with pytest.raises(ValueError):
        j_permute_output_rows(j_prepare_for_kernels(jqt), perm)
    with pytest.raises(ValueError):
        permute_output_rows(prepare_for_kernels(tqt), torch.from_numpy(perm))
    sparse_j = dataclasses.replace(jqt, sparse_values=jnp.zeros((24, 32)))
    sparse_t = dataclasses.replace(tqt, sparse_values=torch.zeros(24, 32))
    with pytest.raises(NotImplementedError):
        j_permute_output_rows(sparse_j, perm)
    with pytest.raises(NotImplementedError):
        permute_output_rows(sparse_t, torch.from_numpy(perm))


# ------------------------------------------------------------------ #
# loading, caches, forward

_LINEARS = ("q_proj", "q_a_proj", "q_b_proj", "kv_a_proj_with_mqa",
            "kv_b_proj", "o_proj")


@pytest.mark.parametrize("q_lora", [32, None])
def test_loaded_params_and_cache_shapes(mla_checkpoints, q_lora):
    """The loaders agree leaf for leaf (rope rows permuted alike); the
    port prepares every MLA linear but kv_b_proj, whose absorbed halves
    equal its dequantized rows; the caches hold one latent head."""
    jp, jc, tp, tc = _both_loaded(mla_checkpoints[q_lora])
    assert tc.is_mla and tc.rope_interleaved and jc.rope_interleaved
    assert tc == LlamaConfig(**dataclasses.asdict(jc))
    for jlayer, tlayer in zip(jp["layers"], tp["layers"]):
        names = {n for n in _LINEARS if n in jlayer}
        assert names == {n for n in _LINEARS if n in tlayer}
        assert ("q_a_proj" in names) == (q_lora is not None)
        for name in names:
            for field in ("weight_packed", "scale", "weight"):
                w, g = getattr(jlayer[name], field), getattr(tlayer[name],
                                                             field)
                if w is not None:
                    np.testing.assert_array_equal(raw_bytes(g), raw_bytes(w))
            prepared = tlayer[name].kernel_meta is not None
            assert prepared == (name != "kv_b_proj"), name
        for norm in ("kv_a_layernorm", "q_a_layernorm"):
            if norm in jlayer:
                np.testing.assert_array_equal(to_numpy(tlayer[norm]),
                                              to_numpy(jlayer[norm]))
        w_kb, w_vb = kv_b_weights({"kv_b_proj": tlayer["kv_b_proj"]}, tc,
                                  torch.float32)
        assert torch.equal(tlayer["w_kb"], w_kb)
        assert torch.equal(tlayer["w_vb"], w_vb)
    for init, kw in ((tl.init_kv_cache, {}),
                     (tl.init_paged_kv_cache, dict(page_size=16))):
        cache = init(tc, 2, 40, dtype=torch.float32, device="cpu", **kw)
        lead = (2, 2, 1, 64) if not kw else (2, 2 * 3 + 1, 1, 16)
        assert tuple(cache.k.shape) == (*lead, R + ROPE)
        assert tuple(cache.v.shape) == (*lead, R)
    jcache = jl.init_kv_cache(jc, 2, 40, dtype=jnp.float32)
    assert jcache.k.shape == (2, 2, 1, 64, 128)


def _run_steps(params, config, ids, steps, package, use_kernels,
               cache_dtype=None):
    """Prefill ``ids`` then decode the (B, n) ``steps`` tokens one column
    at a time: (the logits of every step (n + 1, B, V), the final cache)."""
    B, S = ids.shape
    max_len = S + steps.shape[1] + 1
    outs = []
    if package == "jax":
        cache = jl.init_kv_cache(config, B, max_len, dtype=jnp.float32,
                                 cache_dtype=cache_dtype)
        with j_flags(pallas_interpret=True):
            logits, cache = jl.llama_forward(
                params, config, jnp.asarray(ids),
                jnp.broadcast_to(jnp.arange(S), (B, S)), cache,
                use_kernels=use_kernels)
            outs.append(np.asarray(logits[:, -1], np.float32))
            for j in range(steps.shape[1]):
                logits, cache = jl.llama_forward(
                    params, config, jnp.asarray(steps[:, j:j + 1]),
                    cache.lengths[:, None], cache, use_kernels=use_kernels)
                outs.append(np.asarray(logits[:, 0], np.float32))
        return np.stack(outs), cache
    cache = tl.init_kv_cache(config, B, max_len, dtype=torch.float32,
                             cache_dtype=cache_dtype, device="cpu")
    logits, cache = tl.llama_forward(
        params, config, torch.from_numpy(ids),
        torch.arange(S).expand(B, S), cache, use_kernels=use_kernels)
    outs.append(logits[:, -1].numpy())
    for j in range(steps.shape[1]):
        logits, cache = tl.llama_forward(
            params, config, torch.from_numpy(steps[:, j:j + 1]),
            cache.lengths[:, None].to(torch.int64), cache,
            use_kernels=use_kernels)
        outs.append(logits[:, 0].numpy())
    return np.stack(outs), cache


def _tokens(seed, B=2, S=6, n=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(B, S)),
            rng.integers(0, 256, size=(B, n)))


@pytest.mark.parametrize("q_lora", [32, None])
def test_prefill_and_decode_match_jax(mla_checkpoints, q_lora):
    """Prefill plus 3 decode steps, the port's kernel path (absorbed
    decode over B5-L's plain version) and non-kernel path against the
    JAX package's kernel path (its Pallas decode kernel, interpreted),
    within 1e-4 of max|logits|; the latent caches equal the JAX ones on
    their unpadded widths to f32 rounding (1e-5 of max|cache|: the
    projections sum in another order, 2e-6 apart)."""
    jp, jc, tp, tc = _both_loaded(mla_checkpoints[q_lora])
    ids, steps = _tokens(3)
    want, jcache = _run_steps(jp, jc, ids, steps, "jax", True)
    for use_kernels in (True, False):
        got, cache = _run_steps(fuse_llama_layers(tp), tc, ids, steps,
                                "torch", use_kernels)
        _close(got, want)
        _close(cache.k, np.asarray(jcache.k)[..., :R + ROPE], 1e-5)
        _close(cache.v, np.asarray(jcache.v)[..., :R], 1e-5)
        np.testing.assert_array_equal(cache.lengths.numpy(),
                                      np.asarray(jcache.lengths))


def test_interleaved_rope_dense_checkpoint_matches_jax(tmp_path):
    """A dense (unquantized) deepseek checkpoint, both q variants: the
    loaders' interleaved-to-half permutation gives the JAX logits."""
    for q_lora in (32, None):
        path = _checkpoint(tmp_path / f"dense{q_lora}", q_lora=q_lora,
                           quant=DENSE_CFG, seed=4)
        jp, jc, tp, tc = _both_loaded(path)
        ids = _tokens(5, S=7)[0]
        pos = np.broadcast_to(np.arange(7), ids.shape)
        want = jl.llama_forward(jp, jc, jnp.asarray(ids), jnp.asarray(pos),
                                None)[0]
        for use_kernels in (True, False):
            got = tl.llama_forward(tp, tc, torch.from_numpy(ids),
                                   torch.from_numpy(np.array(pos)),
                                   use_kernels=use_kernels)[0]
            _close(got, want)


def _code_steps(got, want, dtype):
    """Elements of two latent caches of codes that differ, and whether
    each differs by one code (int8: 1; e4m3: the neighbouring bit
    pattern of the same sign)."""
    a, b = raw_bytes(got).astype(np.int64), raw_bytes(want).astype(np.int64)
    if dtype == torch.int8:
        a, b = a.astype(np.int8).astype(np.int64), b.astype(np.int8).astype(
            np.int64)
    diff = a != b
    return int(diff.sum()), bool((np.abs(a - b)[diff] <= 1).all())


@pytest.mark.parametrize("cache", ["fp8", "int8"])
def test_quantized_latent_cache_matches_jax(tmp_path, cache):
    """An fp8 e4m3 or int8 latent cache with the checkpoint's per-tensor
    k/v scales: the port's kernel and non-kernel paths against the JAX
    kernel path within FP8_STEPS of max|logits|; the cached codes equal
    the JAX ones but for elements one code apart (counted)."""
    path = _checkpoint(tmp_path, kv_scales=True, seed=6)
    jp, jc, tp, tc = _both_loaded(path)
    assert tuple(tp["layers"][0]["k_scale"].shape) == (1,)
    tdt = {"fp8": torch.float8_e4m3fn, "int8": torch.int8}[cache]
    jdt = {"fp8": jnp.dtype(ml_dtypes.float8_e4m3fn), "int8": jnp.int8}[cache]
    ids, steps = _tokens(7)
    want, jcache = _run_steps(jp, jc, ids, steps, "jax", True, jdt)
    total = 0
    for use_kernels in (True, False):
        got, tcache = _run_steps(fuse_llama_layers(tp), tc, ids, steps,
                                 "torch", use_kernels, tdt)
        _close(got, want, FP8_STEPS)
        for mine, theirs in ((tcache.k, np.asarray(jcache.k)[..., :R + ROPE]),
                             (tcache.v, np.asarray(jcache.v)[..., :R])):
            n, one_step = _code_steps(mine, theirs, tdt)
            assert one_step
            total += n
    # a few boundary roundings in 2 x 2 caches of 2 x 2 x 64 x (40 + 32)
    assert total <= 16, total


# ------------------------------------------------------------------ #
# the latent-head decode kernels' plain versions

def _latent_operands(rng, B, h, dk, dv, s_pad, dtype, scale):
    """f32 q/new rows and a cache of ``dtype`` (codes of x / scale for
    8-bit caches), as numpy arrays."""
    q = rng.standard_normal((B, h, dk)).astype(np.float32)
    nk = rng.standard_normal((B, 1, dk)).astype(np.float32)
    nv = rng.standard_normal((B, 1, dv)).astype(np.float32)
    shape = (2, B, 1, s_pad)
    ck = rng.standard_normal((*shape, dk)).astype(np.float32)
    cv = rng.standard_normal((*shape, dv)).astype(np.float32)
    if dtype == "fp8":
        ck, cv = ((c / scale).astype(ml_dtypes.float8_e4m3fn) for c in (ck, cv))
    elif dtype == "int8":
        ck, cv = (np.clip(np.round(c / scale), -128, 127).astype(np.int8)
                  for c in (ck, cv))
    return q, nk, nv, ck, cv


def _pad(a, width):
    return np.concatenate([np.asarray(a), np.zeros(
        (*a.shape[:-1], width - a.shape[-1]), np.asarray(a).dtype)], axis=-1)


@pytest.mark.parametrize("h", [1, 16, 20, 128])
def test_latent_operand_check_takes_any_head_count(h):
    """The latent-head kernels' operand check (run before every CUDA
    launch) takes any number of query heads, as the JAX kernels do, and
    still refuses K or V widths the kernels do not serve."""
    def operands(dk, dv):
        z = functools.partial(torch.zeros, dtype=torch.bfloat16)
        return (z(2, h, dk), z(2, 1, dk), z(2, 1, dv), z(1, 2, 1, 64, dk),
                z(1, 2, 1, 64, dv), torch.zeros(2, dtype=torch.int32))

    assert tda.check_latent_operands("t", *operands(576, 512)) == (
        2, h, 576, 512)
    for dk, dv in ((560, 512), (512, 576), (704, 512)):
        with pytest.raises(NotImplementedError):
            tda.check_latent_operands("t", *operands(dk, dv))


@pytest.mark.parametrize("h", [16, 32, 128])
@pytest.mark.parametrize("cache", ["f32", "fp8", "int8"])
def test_latent_plain_versions_match_jax_kernels(cache, h):
    """B5-L's and B7-L's plain versions (one softmax, and the CUDA
    kernels' order: tiles of 16 positions in the segments of
    ``latent_segments``) against the JAX decode and paged decode kernels
    at kvh=1, rep=h, d=Dp, true_d, interpreted, at 16 and 32 query heads
    (one head block of the CUDA kernels, 132 ranges: a segment a tile
    here) and DeepSeek-V2's 128 (two head blocks, 66 ranges), and in the
    kernels' order over 2 ranges (segments of several tiles, a row cut
    between them): the JAX
    call pads q, the rows and the caches to Dp = 128 lanes (V as
    [c_kv ; 0]) and its output is read on the V width. Lengths 0, 63,
    64, 65 and an inactive row. ``attend_plain`` is also taken with runs
    of 64 positions in tiles of 32 (two runs and their merge at lengths
    64 and 65).

    The JAX paged kernel on an fp8 pool gives the row of length 63 an
    output 3e-4 of max|out| away from its own dense kernel on the same
    rows at 16 heads, and 1.02e-3 at 128 (ROADMAP, known caveats); both
    port plain versions agree with the dense kernel to 1e-5, so the paged
    outputs are held to the JAX dense kernel at 1e-5 and to the JAX paged
    kernel at 1e-3 on every row where that kernel stands within 1e-3 of
    its own dense kernel (all rows but at most one)."""
    rng = np.random.default_rng(8)
    B, dk, dv, s_pad, dp, page, true_d = 5, 96, 64, 192, 128, 16, 48
    scale = 0.03
    q, nk, nv, ck, cv = _latent_operands(rng, B, h, dk, dv, s_pad, cache,
                                         scale)
    lens = np.array([0, 63, 64, 65, -1], np.int32)
    scales = ({} if cache == "f32" else
              dict(k_scale=np.float32([scale]), v_scale=np.float32([scale])))
    with j_flags(pallas_interpret=True):
        j_out, j_ck, j_cv = j_decode_attention(
            jnp.asarray(_pad(q, dp)), jnp.asarray(_pad(nk, dp)),
            jnp.asarray(_pad(nv, dp)), jnp.asarray(_pad(ck, dp)),
            jnp.asarray(_pad(cv, dp)), jnp.asarray(lens), kvh=1, rep=h, d=dp,
            true_d=true_d, layer=1,
            **{k: jnp.asarray(v) for k, v in scales.items()})
    t_scales = {k: torch.from_numpy(v) for k, v in scales.items()}
    args = [torch.from_numpy(a) for a in (q, nk, nv)]
    # the JAX block kernel leaves an inactive row's output unwritten; the
    # port's decode kernels write zeros (ROADMAP, known caveats)
    live = lens >= 0
    orders = ((False, None),) if cache == "f32" else (
        (False, None), (True, None), (True, 2))
    segs = tda.latent_segments(torch.from_numpy(lens), s_pad, 2)
    assert segs.sum(dim=1).tolist() == [1, 1, 2, 1, 1]   # row 64 is cut
    for kernel_order, ranges in orders:
        tk, tv = to_torch(ck).clone(), to_torch(cv).clone()
        out, _, _ = tda.latent_decode_attention_plain(
            *args, tk, tv, torch.from_numpy(lens), layer=1, true_d=true_d,
            kernel_order=kernel_order, ranges=ranges, **t_scales)
        _close(out[live], np.asarray(j_out)[live][..., :dv], 1e-5)
        assert not out[~live].any()
        np.testing.assert_array_equal(raw_bytes(tk),
                                      raw_bytes(np.asarray(j_ck)[..., :dk]))
        np.testing.assert_array_equal(raw_bytes(tv),
                                      raw_bytes(np.asarray(j_cv)[..., :dv]))
    # the wrapper takes the latent path on CPU tensors
    tk, tv = to_torch(ck).clone(), to_torch(cv).clone()
    out, _, _ = tda.decode_attention(*args, tk, tv, torch.from_numpy(lens),
                                     layer=1, true_d=true_d, **t_scales)
    assert out.shape == (B, h, dv)
    _close(out[live], np.asarray(j_out)[live][..., :dv], 1e-5)
    # the split-and-tile order with runs of 64 positions
    from compressed_tensors_tpu_torch.models.llama import _quantize_to_cache
    from compressed_tensors_tpu_torch.ops.kernels.flash_decode import (
        attend_plain,
    )

    dtype = to_torch(ck).dtype
    nk_c, nv_c = (_quantize_to_cache(a, t_scales.get(k), dtype, head_axis=1)
                  for a, k in ((args[1], "k_scale"), (args[2], "v_scale")))
    runs = attend_plain(args[0], nk_c, nv_c, to_torch(ck)[1], to_torch(cv)[1],
                        torch.from_numpy(lens), t_scales.get("k_scale"),
                        t_scales.get("v_scale"), split=64, tile=32,
                        inv_sqrt_d=1.0 / np.sqrt(true_d))
    _close(runs[live], np.asarray(j_out)[live][..., :dv], 1e-5)

    # the same rows on pages: live rows' positions through shuffled tables
    P = s_pad // page
    tables = rng.permutation(np.arange(1, B * P + 1)).astype(np.int32)
    tables = tables.reshape(B, P)
    tables[lens < 0] = 0
    pk = np.zeros((2, B * P + 1, 1, page, dk), ck.dtype)
    pv = np.zeros((2, B * P + 1, 1, page, dv), cv.dtype)
    for b in range(B):
        for c in range(P):
            pk[:, tables[b, c], 0] = ck[:, b, 0, c * page:(c + 1) * page]
            pv[:, tables[b, c], 0] = cv[:, b, 0, c * page:(c + 1) * page]
    with j_flags(pallas_interpret=True):
        jp_out, jp_k, jp_v = j_paged_decode_attention(
            jnp.asarray(_pad(q, dp)), jnp.asarray(_pad(nk, dp)),
            jnp.asarray(_pad(nv, dp)), jnp.asarray(_pad(pk, dp)),
            jnp.asarray(_pad(pv, dp)), jnp.asarray(tables), jnp.asarray(lens),
            kvh=1, rep=h, d=dp, true_d=true_d, layer=1,
            **{k: jnp.asarray(v) for k, v in scales.items()})
    for kernel_order, ranges in orders:
        tk, tv = to_torch(pk).clone(), to_torch(pv).clone()
        out, _, _ = tpd.paged_decode_attention_plain(
            *args, tk, tv, torch.from_numpy(tables), torch.from_numpy(lens),
            layer=1, true_d=true_d, kernel_order=kernel_order,
            ranges=ranges, **t_scales)
        _close(out[live], np.asarray(j_out)[live][..., :dv], 1e-5)
        jd, jp = (np.asarray(o)[live][..., :dv] for o in (j_out, jp_out))
        # rows where the JAX paged kernel stands more than 1e-3 of max|out|
        # from its own dense kernel (at 128 heads on fp8: the row of
        # length 63, 1.02e-3) are held to the dense kernel only
        top = np.abs(jd).max()
        kept = np.abs(jp - jd).max(axis=(1, 2)) <= 1e-3 * top
        assert kept.sum() >= len(kept) - 1, kept
        np.testing.assert_allclose(to_numpy(out[live])[kept], jp[kept],
                                   atol=1e-3 * top, rtol=0)
        assert not out[~live].any()
        np.testing.assert_array_equal(raw_bytes(tk)[:, 1:],
                                      raw_bytes(np.asarray(jp_k)[..., :dk])
                                      [:, 1:])
        np.testing.assert_array_equal(raw_bytes(tv)[:, 1:],
                                      raw_bytes(np.asarray(jp_v)[..., :dv])
                                      [:, 1:])


@pytest.mark.parametrize("cache", ["bf16", "fp8"])
def test_latent_flip_bound_covers_another_score_order(cache):
    """The per-element rule the CUDA latent-head kernels are held to on the
    card: |kernel - plain| within 2^-8 |plain| + a summation term + the
    plain version's flip bound (``flip_rel=LATENT_FLIP_REL``). A kernel's
    f32 scores differ from the plain version's in the last bits, and a
    probability near a bf16 rounding midpoint may round to the other
    neighbour. Here the scores move by a relative 2^-18 (the softmax scale
    perturbed, more than another summation order moves them, 16x inside
    the probabilities' 2^-14 that the bound covers): the kernel-order
    output stays within the rule with its flip term at every element, and
    without it some elements fall outside (the term is needed). At 32
    heads (one head block: ``latent_ranges`` 132, about one segment a
    tile here) and 128 (two: 66 ranges). The flip bound needs the split
    order."""
    for h in (32, 128):
        rng = np.random.default_rng(5)
        B, dk, dv, s_pad, true_d = 6, 576, 512, 1024, 192

        def bf16(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(torch.bfloat16)

        q, nk, nv = bf16(B, h, dk), bf16(B, 1, dk), bf16(B, 1, dv)
        ck, cv = bf16(2, B, 1, s_pad, dk), bf16(2, B, 1, s_pad, dv)
        kw = {}
        if cache == "fp8":
            ck, cv = ((c.float() / 0.03).to(torch.float8_e4m3fn)
                      for c in (ck, cv))
            kw = dict(k_scale=torch.tensor([0.03]),
                      v_scale=torch.tensor([0.03]))
        lens = torch.tensor([0, 1, 64, 511, 700, 1023], dtype=torch.int32)
        assert tda.latent_ranges(h) == {32: 132, 128: 66}[h]

        def run(d, **o):
            return tda.latent_decode_attention_plain(
                q, nk, nv, ck.clone(), cv.clone(), lens, layer=1, true_d=d,
                kernel_order=True, out_dtype=torch.float32, **kw, **o)[0]

        want, flip = run(true_d, flip_rel=tda.LATENT_FLIP_REL)
        torch.testing.assert_close(want, run(true_d), rtol=0, atol=0)
        assert bool((flip >= 0).all()) and bool((flip > 0).any())
        moved = run(true_d * (1 + 2**-18))
        diff = (moved - want).abs()
        rule = 2**-8 * want.abs() + 1e-6 * want.abs().max()
        assert not bool((diff > rule + flip).any())
        assert bool((diff > rule).any())
    with pytest.raises(ValueError, match="split"):
        tda.latent_decode_attention_plain(
            q, nk, nv, ck.clone(), cv.clone(), lens, layer=1, true_d=true_d,
            flip_rel=tda.LATENT_FLIP_REL, **kw)


# ------------------------------------------------------------------ #
# MoE, generation, serving, checkpoints

def _moe_checkpoint(tmp_path):
    cfg = dict(MLA_CONFIG, q_lora_rank=None, num_experts=4,
               num_experts_per_tok=2, moe_intermediate_size=32)
    path, _ = make_tiny_llama_checkpoint(
        pathlib.Path(tmp_path), np.random.default_rng(9), W4A16_G16,
        model_config=cfg)
    return path


def test_mla_moe_model_matches_jax(tmp_path, monkeypatch):
    """A tiny MLA + MoE model (4 experts, top 2, DeepSeek routing without
    renormalisation): prefill and 3 decode steps on both paths against the
    JAX package, at capacity factor 4.0 in both packages (no slot is
    dropped, so the port's real-length rows and the JAX package's route
    alike)."""
    for module in (tmoe, jmoe):
        monkeypatch.setattr(module, "moe_mlp", functools.partial(
            module.moe_mlp, capacity_factor=4.0))
    path = _moe_checkpoint(tmp_path)
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    cfg["norm_topk_prob"] = False
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    jp, jc, tp, tc = _both_loaded(path)
    assert tc.is_moe and tc.is_mla and not tc.norm_topk_prob
    assert tp["layers"][1]["moe"]["experts"]["up_proj"].kernel_meta[0] \
        == "w4a16"
    ids, steps = _tokens(10)
    want, _ = _run_steps(jp, jc, ids, steps, "jax", True)
    for use_kernels in (True, False):
        got, _ = _run_steps(fuse_llama_layers(tp), tc, ids, steps, "torch",
                            use_kernels)
        _close(got, want)


def test_greedy_generate_matches_jax(mla_checkpoints):
    jp, jc, tp, tc = _both_loaded(mla_checkpoints[32])
    ids = _tokens(11, S=5)[0]
    with j_flags(pallas_interpret=True):
        want = np.asarray(j_generate(jp, jc, jnp.asarray(ids),
                                     max_new_tokens=6, dtype=jnp.float32))
    got = greedy_generate(fuse_llama_layers(tp), tc, ids, max_new_tokens=6,
                          dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def _serve(engine_cls, request_cls, params, config, prompts, new, **kw):
    eng = engine_cls(params, config, **kw)
    for i, p in enumerate(prompts):
        eng.submit(request_cls(request_id=i, prompt_ids=p,
                               max_new_tokens=new))
    return {c.request_id: list(c.output_ids) for c in eng.run()}


def test_serving_dense_paged_and_jax(mla_checkpoints):
    """The port's ServingEngine on the MLA model: dense (absorbed decode
    over B5-L's plain version) and paged (B7-L's, with the gather/scatter
    prefill) give the same completions, and those of the JAX engine."""
    jp, jc, tp, tc = _both_loaded(mla_checkpoints[None])
    tp = fuse_llama_layers(tp)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (6, 9, 4)]
    kw = dict(max_batch=2, max_len=32, prefill_chunk=8)
    dense = _serve(ServingEngine, Request, tp, tc, prompts, 5,
                   dtype=torch.float32, device="cpu", **kw)
    paged = _serve(ServingEngine, Request, tp, tc, prompts, 5, paged=True,
                   page_size=8, dtype=torch.float32, device="cpu", **kw)
    assert dense == paged
    theirs = _serve(JEngine, JRequest, jp, jc, prompts, 5, dtype=jnp.float32,
                    use_kernels=False, **kw)
    assert dense == theirs


def test_port_written_mla_checkpoint_loads_in_both(mla_checkpoints,
                                                   tmp_path):
    """save_llama_checkpoint writes the loaded MLA params as a DeepSeek V2
    checkpoint with the rope rows back in interleaved order: both loaders
    read it to the params' own logits, and its greedy tokens are the
    params'."""
    _, _, tp, tc = _both_loaded(mla_checkpoints[32])
    save_llama_checkpoint(tp, tc, str(tmp_path))
    with open(os.path.join(tmp_path, "config.json")) as f:
        assert json.load(f)["model_type"] == "deepseek_v2"
    jp2, jc2, tp2, tc2 = _both_loaded(str(tmp_path))
    assert tc2 == tc
    layer, layer2 = tp["layers"][0], tp2["layers"][0]
    for name in ("q_b_proj", "kv_a_proj_with_mqa", "kv_b_proj"):
        assert torch.equal(layer2[name].weight_packed,
                           layer[name].weight_packed), name
    perm = mla_rope_perms(tc)["kv_a_proj_with_mqa"]
    assert not torch.equal(perm, torch.arange(perm.numel()))
    ids = _tokens(13, S=8)[0]
    pos = np.broadcast_to(np.arange(8), ids.shape)
    want = tl.llama_forward(tp, tc, torch.from_numpy(ids),
                            torch.from_numpy(np.array(pos)))[0]
    _close(tl.llama_forward(tp2, tc2, torch.from_numpy(ids),
                            torch.from_numpy(np.array(pos)))[0], want)
    _close(jl.llama_forward(jp2, jc2, jnp.asarray(ids), jnp.asarray(pos),
                            None, use_kernels=False)[0], want)
    tokens = [greedy_generate(fuse_llama_layers(p), tc, ids[:, :5],
                              max_new_tokens=5, dtype=torch.float32,
                              device="cpu") for p in (tp, tp2)]
    assert torch.equal(*tokens)
