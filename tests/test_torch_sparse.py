"""2:4 sparse-24-bitmask (BASELINE config 4) in the PyTorch port against the
JAX package, on the CPU: the bitmask and 2:4 codecs bit for bit (ties,
groups with fewer than two nonzeros), the sparse compressors and their
stacking over the quantization codecs, the sparse ``prepare_for_kernels``
(the kernels' plain versions) against the sparse non-kernel path
(y within 1e-5 * max|y| in f32), and sparse Llama checkpoints loaded by
both packages (logits within 1e-3 * max|logits| in f32, greedy tokens
equal)."""

import dataclasses
import pathlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from compressed_tensors_tpu.compressors import (
    ModelCompressor as JModelCompressor,
    module_graph_from_names as j_graph,
)
from compressed_tensors_tpu.compressors.sparse import (
    BitmaskCompressor as JBitmask,
    Sparse24BitMaskCompressor as JSparse24,
)
from compressed_tensors_tpu.engine import greedy_generate as j_generate
from compressed_tensors_tpu.models import llama as jl
from compressed_tensors_tpu.ops import bitmask as jb
from compressed_tensors_tpu.ops import calculate_qparams as j_qparams
from compressed_tensors_tpu.ops.linear import (
    QuantizedTensor as JQuantizedTensor,
    from_compressed_state as j_from_state,
    materialize_weight as j_materialize,
    quantized_matmul as j_matmul,
)
from compressed_tensors_tpu.ops.quantize import quantize as j_quantize
from compressed_tensors_tpu.quantization import (
    preset_name_to_scheme as j_preset,
)
from testing_utils import make_tiny_llama_checkpoint

from compressed_tensors_tpu_torch.compressors import (
    BitmaskCompressor,
    ModelCompressor,
    Sparse24BitMaskCompressor,
    compress_state_dict,
    decompress_state_dict,
    module_graph_from_names,
)
from compressed_tensors_tpu_torch.engine import greedy_generate
from compressed_tensors_tpu_torch.interop import params_from_numpy
from compressed_tensors_tpu_torch.models import llama as tl
from compressed_tensors_tpu_torch.models.config import LlamaConfig
from compressed_tensors_tpu_torch.models.synthetic import (
    make_synthetic_llama,
    save_llama_checkpoint,
)
from compressed_tensors_tpu_torch.ops import bitmask as tb
from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers
from compressed_tensors_tpu_torch.ops.linear import (
    from_compressed_state,
    materialize_weight,
    prepare_for_kernels,
    quantized_matmul,
)
from compressed_tensors_tpu_torch.ops.pack import (
    pack_to_int32,
    unpack_from_int32,
)
from compressed_tensors_tpu_torch.quantization import preset_name_to_scheme

from torch_port_utils import (
    TORCH_TINY_CONFIG,
    jax_params_to_numpy,
    raw_bytes,
    to_numpy,
    to_torch,
)

SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
             num_hidden_layers=2, num_attention_heads=8,
             num_key_value_heads=2, head_dim=32)


def _bits(t) -> np.ndarray:
    """The raw bytes of a torch tensor or JAX/numpy array, with its dtype's
    width (bf16 through an int16 view)."""
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    a = raw_bytes(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same_bits(got, want):
    got, want = _bits(got), _bits(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _close(got, want, rel):
    want = to_numpy(want)
    np.testing.assert_allclose(to_numpy(got), want,
                               atol=rel * np.abs(want).max(), rtol=0)


def _tied_weight(rng, shape):
    """Small integers: most groups of four hold ties, some hold fewer than
    two nonzeros (all zero, one nonzero) and some a -0.0."""
    w = rng.integers(-2, 3, size=shape).astype(np.float32)
    w[0, :4] = 0.0
    w[0, 4:8] = [0.0, 0.0, 0.0, 3.0]
    w[1, :4] = [-0.0, 0.0, -1.0, 0.0]
    w[1, 4:8] = [2.0, -2.0, 2.0, -2.0]
    return w


# ------------------------------------------------------------------ codecs

@pytest.mark.parametrize("shape", [(13, 37), (4, 8), (3, 1)])
def test_pack_bitmasks_bit_for_bit(shape):
    mask = np.random.default_rng(0).random(shape) > 0.5
    got = tb.pack_bitmasks(torch.from_numpy(mask))
    _same_bits(got, jb.pack_bitmasks(jnp.asarray(mask)))
    _same_bits(got, np.packbits(mask, axis=-1, bitorder="little"))
    back = tb.unpack_bitmasks(got, shape)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jb.unpack_bitmasks(jnp.asarray(
            got.numpy()), shape)))
    np.testing.assert_array_equal(back.numpy(), mask)


def test_get_24_bytemasks_ties_and_sparse_groups():
    w = _tied_weight(np.random.default_rng(1), (16, 64))
    w[2, :4] = [np.nan, 1.0, np.nan, 0.0]   # NaN sorts after every |w|
    w[2, 4:8] = [np.nan, np.nan, np.nan, np.nan]
    w[2, 8:12] = [-np.inf, 3.0, np.inf, -3.0]
    got = tb.get_24_bytemasks(torch.from_numpy(w))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jb.get_24_bytemasks(jnp.asarray(w))))
    assert (got.reshape(-1, 4).sum(-1) == 2).all()
    # two positions marked in an all-zero group: not w != 0
    assert got[0, :4].tolist() == [True, True, False, False]
    assert got[0, 4:8].tolist() == [True, False, False, True]
    assert got[1, 4:8].tolist() == [True, True, False, False]
    assert got[2, :4].tolist() == [False, True, False, True]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_sparse24_codec_bit_for_bit(dtype):
    w = _tied_weight(np.random.default_rng(2), (24, 64))
    w = w.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)
    got_c, got_m = tb.sparse24_compress(to_torch(w))
    want_c, want_m = jb.sparse24_compress(jnp.asarray(w))
    _same_bits(got_c, want_c)
    _same_bits(got_m, want_m)
    dense = tb.sparse24_decompress(got_c, got_m, (24, 64))
    _same_bits(dense, jb.sparse24_decompress(want_c, want_m, (24, 64)))
    assert tb.tensor_follows_mask_structure(dense, "2:4")
    # any bit pattern, 0-4 kept a group: the same scatter as the JAX one
    bits = np.random.default_rng(3).integers(0, 256, (24, 8), dtype=np.uint8)
    _same_bits(tb.sparse24_decompress(got_c, torch.from_numpy(bits),
                                      (24, 64)),
               jb.sparse24_decompress(want_c, jnp.asarray(bits), (24, 64)))


def test_bitmask_codec_bit_for_bit():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(9, 41)).astype(np.float32)
    w[rng.random(w.shape) < 0.7] = 0.0
    w[2, 3] = -0.0
    got = tb.bitmask_compress(torch.from_numpy(w))
    want = jb.bitmask_compress(jnp.asarray(w))
    for g, j in zip(got, want):
        _same_bits(g, j)
    assert got[2].dtype == torch.int32
    dense = tb.bitmask_decompress(got[0], got[1], (9, 41))
    _same_bits(dense, jb.bitmask_decompress(want[0], want[1], (9, 41)))
    np.testing.assert_array_equal(dense.numpy(), w)


def test_tensor_follows_mask_structure():
    w = np.zeros((2, 8), np.float32)
    w[0, :2] = 1.0
    for mask in ("2:4", "1:4", "1:2"):
        assert tb.tensor_follows_mask_structure(torch.from_numpy(w), mask) \
            == jb.tensor_follows_mask_structure(jnp.asarray(w), mask)


def test_unstructured_bitmask_does_not_run_compressed():
    """The JAX package's run-compressed path scatters every sparse leaf as
    2:4: an unstructured layer, even one with exactly half its entries
    nonzero (so its 1-D values reshape to (R, C/2)), comes out wrong. The
    port refuses such layers there, and decompresses them through the
    ModelCompressor."""
    rng = np.random.default_rng(4)
    w = np.zeros((8, 32), np.float32)
    for r in range(8):  # 16 of 32 nonzero, not 2:4 (a run of 16)
        start = int(rng.integers(0, 17))
        w[r, start:start + 16] = rng.uniform(1, 2, 16)
    state = JBitmask.compress({"weight": jnp.asarray(w)})
    jqt = JQuantizedTensor(sparse_values=state["weight.compressed"],
                           sparse_bitmask=state["weight.bitmask"],
                           shape=(8, 32), format="dense")
    assert not np.array_equal(np.asarray(j_materialize(jqt, jnp.float32)), w)
    tstate = BitmaskCompressor.compress({"weight": torch.from_numpy(w)})
    with pytest.raises(NotImplementedError, match="unstructured"):
        from_compressed_state(tstate, preset_name_to_scheme("W4A16",
                                                            ["Linear"]))
    back = BitmaskCompressor.decompress(tstate)
    np.testing.assert_array_equal(back["weight"].numpy(), w)


# ------------------------------------------------------------- compressors

@pytest.mark.parametrize("codec", ["sparse-24-bitmask", "sparse-bitmask"])
def test_sparse_compressors_match_jax(codec):
    rng = np.random.default_rng(5)
    w = _tied_weight(rng, (16, 32)).astype(np.int8)
    ours = {"sparse-24-bitmask": Sparse24BitMaskCompressor,
            "sparse-bitmask": BitmaskCompressor}[codec]
    theirs = {"sparse-24-bitmask": JSparse24,
              "sparse-bitmask": JBitmask}[codec]
    scale = rng.uniform(1e-3, 2e-3, (16, 1)).astype(np.float32)
    got = ours.compress({"weight": torch.from_numpy(w),
                         "weight_scale": torch.from_numpy(scale)})
    want = theirs.compress({"weight": jnp.asarray(w),
                            "weight_scale": jnp.asarray(scale)})
    assert sorted(got) == sorted(want)
    for key in got:
        _same_bits(got[key], want[key])
    # the registry resolves the format name to the same codec
    via = compress_state_dict({"weight": torch.from_numpy(w)},
                              preset_name_to_scheme("W8A8", ["Linear"]),
                              format=codec)
    _same_bits(via["weight.compressed"], want["weight.compressed"])
    back = decompress_state_dict(via, preset_name_to_scheme(
        "W8A8", ["Linear"]), format=codec)
    _same_bits(back["weight"], theirs.decompress(want)["weight"])


@pytest.mark.parametrize("fmt", ["naive-quantized", "pack-quantized"])
def test_model_compressor_stacks_sparse_over_quant(fmt):
    """The quantization codec first, then the 2:4 codec over the values it
    leaves; pack-quantized leaves no ``weight``, so it stays unsparsified,
    in both packages."""
    config = {
        "config_groups": {"group_0": {
            "targets": ["Linear"],
            "weights": {"num_bits": 4, "type": "int", "symmetric": True,
                        "strategy": "group", "group_size": 16}}},
        "format": fmt,
        "sparsity_config": {"format": "sparse-24-bitmask",
                            "targets": ["Linear"],
                            "sparsity_structure": "2:4"},
        "quant_method": "compressed-tensors"}
    rng = np.random.default_rng(6)
    w = rng.normal(size=(16, 32)).astype(np.float32)
    w = w * np.asarray(jb.get_24_bytemasks(jnp.asarray(w)))
    args = j_preset("W4A16", ["Linear"]).weights.model_copy(
        update={"group_size": 16})
    g = w.reshape(16, -1, 16)
    scale, _ = j_qparams(jnp.asarray(g.min(-1)), jnp.asarray(g.max(-1)), args)
    names = ["layer.proj"]
    jmc = JModelCompressor.from_compression_config(config)
    want = jmc.compress_state(
        {"layer.proj": {"weight": jnp.asarray(w), "weight_scale": scale}},
        j_graph(names))["layer.proj"]
    mc = ModelCompressor.from_compression_config(config)
    modules = module_graph_from_names(names)
    got = mc.compress_state(
        {"layer.proj": {"weight": torch.from_numpy(w),
                        "weight_scale": to_torch(scale)}},
        modules)["layer.proj"]
    assert sorted(got) == sorted(want)
    assert ("weight.compressed" in got) == (fmt == "naive-quantized")
    for key in got:
        _same_bits(got[key], want[key])
    back = mc.decompress_state({"layer.proj": got}, modules)["layer.proj"]
    jback = jmc.decompress_state({"layer.proj": want}, j_graph(names))
    _close(back["weight"], jback["layer.proj"]["weight"], 1e-6)
    assert (back["weight"].numpy()[w == 0] == 0).all()


# ------------------------------------------------------------ linear prep

def _sparse_state(rng, preset, n=64, k=256):
    """A 2:4-sparse weight quantized and stacked as ModelCompressor does,
    by the JAX package: (numpy state, scheme, dense masked weight)."""
    scheme = j_preset(preset, ["Linear"])
    args = scheme.weights
    w = (rng.normal(size=(n, k)) * 0.1).astype(np.float32)
    w = w * np.asarray(jb.get_24_bytemasks(jnp.asarray(w)))
    if args.strategy == "group":
        g = w.reshape(n, -1, args.group_size)
        mn, mx = g.min(-1), g.max(-1)
    else:
        mn, mx = w.min(-1, keepdims=True), w.max(-1, keepdims=True)
    scale, zp = j_qparams(jnp.asarray(mn), jnp.asarray(mx), args)
    state = {"weight": j_quantize(jnp.asarray(w), scale, zp, args,
                                  dtype=jnp.int8), "weight_scale": scale}
    if not args.symmetric:
        state["weight_zero_point"] = zp
    state = JSparse24.compress(state, scheme)
    return {k: np.asarray(v) for k, v in state.items()}, w


def _port_qt(state, preset):
    return from_compressed_state({k: to_torch(v) for k, v in state.items()},
                                 preset_name_to_scheme(preset, ["Linear"]))


@pytest.mark.parametrize("preset,layout,kind", [
    ("W4A16", "auto", "w4a16"), ("W4A16", "packed", "w4packed"),
    ("W4A16", "e8", "w4e8"), ("W8A8", None, "w8a8")])
def test_sparse_prepare_matches_sparse_non_kernel_path(preset, layout, kind):
    rng = np.random.default_rng(7)
    state, w = _sparse_state(rng, preset)
    qt = _port_qt(state, preset)
    prepped = prepare_for_kernels(qt, w4_layout=layout)
    assert prepped.kernel_meta[0] == kind
    assert prepped.sparse_values is None and prepped.sparse_bitmask is None
    # (B, S, K) as in a model: dynamic token scales reduce over K only
    x = (rng.normal(size=(1, 4, 256)) * 0.5).astype(np.float32)
    y = quantized_matmul(torch.from_numpy(x), prepped)
    ref = quantized_matmul(torch.from_numpy(x), qt, use_kernels=False)
    if kind == "w8a8":
        # the sparse non-kernel path dequantizes the weight and keeps x in
        # f32 (as in JAX); the kernel quantizes x per token, as the dense
        # int8 weight's non-kernel path does
        _close(y, ref, 2e-2)
        ref_int8 = quantized_matmul(torch.from_numpy(x), dataclasses.replace(
            prepped, kernel_meta=None), use_kernels=False)
        _close(y, ref_int8, 1e-5)
    else:
        _close(y, ref, 1e-5)
    jqt = j_from_state({k: jnp.asarray(v) for k, v in state.items()},
                       j_preset(preset, ["Linear"]))
    _close(ref, j_matmul(jnp.asarray(x), jqt, use_kernels=False), 1e-5)
    dense = materialize_weight(qt, dtype=torch.float32)
    _close(dense, j_materialize(jqt, dtype=jnp.float32), 1e-6)
    assert (dense.numpy()[w == 0] == 0).all()
    if kind == "w4a16":  # the kernel words are the masked codes' words
        codes = tb.sparse24_decompress(qt.sparse_values, qt.sparse_bitmask,
                                       qt.shape)
        assert torch.equal(prepped.kernel_packed, pack_to_int32(codes, 4))


def test_sparse_asymmetric_stays_sparse():
    """An asymmetric scheme cannot scatter its dropped positions as code 0:
    it keeps the sparse leaves and the non-kernel path, as in JAX."""
    rng = np.random.default_rng(8)
    state, _ = _sparse_state(rng, "W4A16_ASYM")
    qt = prepare_for_kernels(_port_qt(state, "W4A16_ASYM"))
    assert qt.kernel_meta is None and qt.sparse_values is not None
    x = rng.normal(size=(3, 256)).astype(np.float32)
    jqt = j_from_state({k: jnp.asarray(v) for k, v in state.items()},
                       j_preset("W4A16_ASYM", ["Linear"]))
    _close(quantized_matmul(torch.from_numpy(x), qt),
           j_matmul(jnp.asarray(x), jqt, use_kernels=False), 1e-5)


# ------------------------------------------------------------------ models

def sparse_w4a16_config():
    """BASELINE config 4 at tiny size: W4A16 g128 codes stored
    naive-quantized under a sparse-24-bitmask sparsity config (the lm_head
    unquantized, its f32 weight 2:4-sparse as well)."""
    return {
        "config_groups": {"group_0": {
            "targets": ["Linear"],
            "weights": {"num_bits": 4, "type": "int", "symmetric": True,
                        "strategy": "group", "group_size": 128}}},
        "format": "naive-quantized",
        "ignore": ["lm_head"],
        "sparsity_config": {"format": "sparse-24-bitmask",
                            "targets": ["Linear"],
                            "sparsity_structure": "2:4"},
        "quant_method": "compressed-tensors",
        "quantization_status": "compressed",
    }


def _ids(B, S, seed=1):
    return np.random.default_rng(seed).integers(0, 512, size=(B, S))


def _logits(params, config, ids, package, use_kernels=False):
    pos = np.broadcast_to(np.arange(ids.shape[1]), ids.shape)
    if package == "jax":
        return jl.llama_forward(params, config, jnp.asarray(ids),
                                jnp.asarray(pos), use_kernels=False)[0]
    return tl.llama_forward(params, config, torch.from_numpy(ids),
                            torch.from_numpy(np.array(pos)),
                            use_kernels=use_kernels)[0]


@pytest.fixture(scope="module")
def sparse_ckpt(tmp_path_factory):
    """The JAX package's save path writes the sparse checkpoint; both
    packages load it (the port with its kernel layouts, f32)."""
    path, _ = make_tiny_llama_checkpoint(
        pathlib.Path(tmp_path_factory.mktemp("sparse")),
        np.random.default_rng(0), sparse_w4a16_config(),
        model_config=TORCH_TINY_CONFIG)
    jp, jc, _ = jl.load_llama_params(path, dtype=jnp.float32,
                                     use_kernels=False)
    tp, tc, mc = tl.load_llama_params(path, dtype=torch.float32,
                                      device="cpu")
    return path, jp, jc, tp, tc, mc


def test_sparse_checkpoint_logits_and_tokens(sparse_ckpt):
    _, jp, jc, tp, tc, mc = sparse_ckpt
    # the JAX package's update_config writes an empty sparsity_config
    # (ROADMAP, known caveats): the weight.compressed tensors alone mark
    # the sparse modules, in both loaders
    assert mc.sparsity_config is None
    layer = tp["layers"][1]
    assert layer["q_proj"].kernel_meta == ("w4a16", 256, 256, 128)
    assert layer["q_proj"].sparse_values is None
    assert tp["lm_head"].sparse_values is not None  # float, non-kernel
    assert jp["layers"][1]["q_proj"].sparse_values is not None
    ids = _ids(2, 24)
    want = _logits(jp, jc, ids, "jax")
    _close(_logits(tp, tc, ids, "torch", use_kernels=True), want, 1e-3)
    _close(_logits(tp, tc, ids, "torch"), want, 1e-3)
    want_tok = np.asarray(j_generate(jp, jc, jnp.asarray(ids[:, :16]),
                                     max_new_tokens=6, dtype=jnp.float32,
                                     use_kernels=False))
    got_tok = greedy_generate(fuse_llama_layers(tp), tc, ids[:, :16],
                              max_new_tokens=6, dtype=torch.float32,
                              device="cpu")
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)


def test_sparse_params_from_numpy(sparse_ckpt):
    """The JAX package's sparse params (sparse leaves, no kernel layout)
    carried over: the port scatters them into its kernel layouts."""
    _, jp, jc, tp, tc, _ = sparse_ckpt
    tree = jax_params_to_numpy(jp)

    def add_sparse(j, t):
        if isinstance(j, JQuantizedTensor):
            t["sparse_values"] = (None if j.sparse_values is None
                                  else np.asarray(j.sparse_values))
            t["sparse_bitmask"] = (None if j.sparse_bitmask is None
                                   else np.asarray(j.sparse_bitmask))
        elif isinstance(j, dict):
            for k in j:
                add_sparse(j[k], t[k])
        elif isinstance(j, list):
            for a, b in zip(j, t):
                add_sparse(a, b)

    add_sparse(jp, tree)
    carried = params_from_numpy(tree, device="cpu")
    q = carried["layers"][0]["gate_proj"]
    assert q.kernel_meta[0] == "w4a16" and q.sparse_values is None
    assert torch.equal(q.kernel_packed,
                       tp["layers"][0]["gate_proj"].kernel_packed)
    ids = _ids(2, 12, seed=2)
    _close(_logits(carried, tc, ids, "torch", use_kernels=True),
           _logits(jp, jc, ids, "jax"), 1e-3)


def test_port_sparse_checkpoint_loads_in_both(tmp_path):
    """The port's sparse synthetic model (the W4A16 draw masked to 2:4)
    written by ``save_llama_checkpoint``: both packages load it, and its
    kernel words equal those of the W4A16 model built from the same
    masked codes."""
    config = LlamaConfig(**SMALL)
    params = make_synthetic_llama(config, "W4A16", seed=5, device="cpu",
                                  dtype=torch.float32, use_kernels=False,
                                  lm_head_preset="W8A8", sparsity="2:4")
    dense_twin = make_synthetic_llama(config, "W4A16", seed=5, device="cpu",
                                      dtype=torch.float32, use_kernels=False,
                                      lm_head_preset="W8A8")
    save_llama_checkpoint(params, config, str(tmp_path))
    jp, jc, _ = jl.load_llama_params(str(tmp_path), dtype=jnp.float32,
                                     use_kernels=False)
    tp, tc, mc = tl.load_llama_params(str(tmp_path), dtype=torch.float32,
                                      device="cpu")
    assert mc.sparsity_config.ignore == ["lm_head"]
    assert tp["lm_head"].kernel_meta == ("w8a8", 512, 256)
    for name in ("q_proj", "down_proj"):
        sparse, twin = params["layers"][1][name], dense_twin["layers"][1][name]
        codes = unpack_from_int32(twin.weight_packed, 4, twin.shape)
        codes = codes * tb.get_24_bytemasks(codes)
        assert torch.equal(tp["layers"][1][name].kernel_packed,
                           pack_to_int32(codes, 4))
        assert torch.equal(sparse.scale, twin.scale)
    ids = _ids(2, 10, seed=3)
    want = _logits(jp, jc, ids, "jax")
    _close(_logits(tp, tc, ids, "torch"), want, 1e-3)
    direct = _logits(params, config, ids, "torch")
    np.testing.assert_array_equal(_logits(tp, tc, ids, "torch").numpy(),
                                  direct.numpy())
