"""The transforms of compressed_tensors_tpu_torch (``transform/``) against
the JAX package's: schemas dumped alike, Hadamard constructions and random
draws bit for bit, the correctness quartets, SpinQuant-style R1 + R2
fused into a tiny Llama within one ulp, a rotated model quantized, saved
by the port and read by both packages, and the online-transform refusal."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import compressed_tensors_tpu as jct
import compressed_tensors_tpu.transform as jtr
import compressed_tensors_tpu_torch as tct
import compressed_tensors_tpu_torch.transform as ttr
from compressed_tensors_tpu.models import llama as jl
from compressed_tensors_tpu.transform import hadamard as jh
from compressed_tensors_tpu.transform.hadamard_data import (
    known_base_orders as j_known_orders,
)
from compressed_tensors_tpu.transform.hadamard_data import (
    known_hadamard as j_known,
)
from compressed_tensors_tpu.utils.match import ModuleInfo as JInfo
from compressed_tensors_tpu_torch.models import llama as tl
from compressed_tensors_tpu_torch.quantization import lifecycle as tlc
from compressed_tensors_tpu_torch.transform import hadamard as th
from compressed_tensors_tpu_torch.transform.hadamard_data import (
    known_base_orders,
    known_hadamard,
)
from compressed_tensors_tpu_torch.utils.match import ModuleInfo as TInfo
from torch_port_utils import TORCH_TINY_CONFIG, to_numpy

CFG = TORCH_TINY_CONFIG
TYPES = ("hadamard", "random-hadamard", "random-matrix")


def spinquant_config(head_dim, online=False):
    """SpinQuant's R1 + R2 as llm-compressor writes them; with ``online``
    an R4-style ``input`` rotation of down_proj and per-head q/k rotations
    in bf16 besides."""
    groups = {
        "R1": {"type": "random-hadamard", "apply": [
            {"targets": ["re:.*embed_tokens$", "re:.*o_proj$",
                         "re:.*down_proj$"], "location": "weight_output"},
            {"targets": ["re:.*q_proj$", "re:.*k_proj$", "re:.*v_proj$",
                         "re:.*gate_proj$", "re:.*up_proj$", "lm_head"],
             "location": "weight_input", "inverse": True}]},
        "R2": {"type": "random-hadamard", "head_dim": head_dim, "apply": [
            {"targets": ["re:.*v_proj$"], "location": "weight_output"},
            {"targets": ["re:.*o_proj$"], "location": "weight_input",
             "inverse": True}]},
    }
    if online:
        groups["R4"] = {"type": "hadamard", "apply": [
            {"targets": ["re:.*down_proj$"], "location": "input"}]}
        groups["R3"] = {"type": "hadamard", "head_dim": head_dim,
                        "precision": "torch.bfloat16", "apply": [
                            {"targets": ["re:.*self_attn$"],
                             "location": "q_attn"},
                            {"targets": ["re:.*self_attn$"],
                             "location": "k_cache"}]}
    return {"config_groups": groups}


# --------------------------------------------------------------------------- #
# schemas

SCHEMA_CORPUS = [
    ("args", {"targets": ["Embedding"], "location": "input"}),
    ("args", {"targets": "target", "location": "weight_output",
              "ignore": "ignore"}),
    ("args", {"targets": ["Linear"], "location": "weight_input",
              "inverse": True, "ignore": ["model.layers.2"]}),
    ("args", {"targets": ["re:.*self_attn$"], "location": "k_cache"}),
    ("scheme", {"type": "hadamard"}),
    ("scheme", {"type": "random-matrix", "randomize": True,
                "requires_grad": True, "head_dim": 64,
                "precision": "torch.bfloat16",
                "apply": [{"targets": ["Linear"], "location": "output"}]}),
    ("scheme", {"type": "random-hadamard", "precision": "torch.float64",
                "apply": [{"targets": ["Embedding"], "location": "input"},
                          {"targets": ["Linear"],
                           "location": "weight_input"}]}),
    ("config", spinquant_config(128)),
    ("config", spinquant_config(64, online=True)),
    ("config", {"config_groups": {}}),
]
SCHEMA_CLASSES = {"args": "TransformArgs", "scheme": "TransformScheme",
                  "config": "TransformConfig"}


@pytest.mark.parametrize("kind,data", SCHEMA_CORPUS)
def test_schema_dump_matches_jax(kind, data):
    """``model_dump(mode="json")`` equal to the JAX package's, and the dump
    validates back to the same object in both."""
    cls = SCHEMA_CLASSES[kind]
    got = getattr(ttr, cls).model_validate(data)
    want = getattr(jtr, cls).model_validate(data)
    dump = got.model_dump(mode="json")
    assert dump == want.model_dump(mode="json")
    assert json.dumps(dump, sort_keys=True) == json.dumps(
        want.model_dump(mode="json"), sort_keys=True)
    assert getattr(ttr, cls).model_validate(dump) == got
    assert getattr(jtr, cls).model_validate(dump) == want


def test_schema_defaults_and_online_locations():
    scheme = ttr.TransformScheme(type="hadamard")
    assert scheme.precision == torch.float32 and not scheme.randomize
    online = {loc.value for loc in ttr.TransformLocation if loc.is_online()}
    assert online == {"input", "output", "k_cache", "q_attn"}
    assert online == {loc.value for loc in jtr.TransformLocation
                      if loc.is_online()}
    with pytest.raises(ValueError):
        ttr.TransformArgs(targets=["x"], location="weight_input", bad=1)


# --------------------------------------------------------------------------- #
# Hadamard constructions and random draws

# beyond 256 (where Paley II gives 52, 100 and 244): doubling orders
# (296 = 2 x 148 and 592 = 4 x 148 over Paley II's 148, 472 = 2 x 236 over
# the table, 464 = 4 x 116), and 1000 (Paley I's 500 = 499 + 1, doubled)
LARGER_ORDERS = (296, 464, 472, 592, 1000)


@pytest.mark.parametrize("size", [1, 2] + list(range(4, 257, 4))
                         + list(LARGER_ORDERS))
def test_hadamard_matrix_bit_equal(size):
    got = th.hadamard_matrix(size, device="cpu")
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), jh.hadamard_matrix(size))
    if size <= 256:
        np.testing.assert_array_equal((got @ got.T).numpy(),
                                      size * np.eye(size))


def test_tabled_orders_and_constructions():
    assert known_base_orders() == j_known_orders() == [92, 116, 156, 172,
                                                       188, 236]
    for k in known_base_orders():
        np.testing.assert_array_equal(known_hadamard(k), j_known(k))
        assert th.hadamard_construction(k) == f"tabled order {k}"
    assert th.hadamard_construction(52) == "Paley II (q = 25)"
    assert th.hadamard_construction(296) == "Paley II (q = 73) doubled 1x"
    assert th.hadamard_construction(256) == "Sylvester 256"
    assert th.hadamard_construction(768) == "Paley I (q = 383) doubled 1x"
    assert th.hadamard_construction(472) == "tabled order 236 doubled 1x"
    assert th.hadamard_construction(96) == "Paley I (q = 47) doubled 1x"
    np.testing.assert_array_equal(
        th.deterministic_hadamard_matrix(64, device="cpu").numpy(),
        jh.deterministic_hadamard_matrix(64))
    with pytest.raises(ValueError):
        th.deterministic_hadamard_matrix(12, device="cpu")
    with pytest.raises(ValueError):
        th.hadamard_matrix(6, device="cpu")


@pytest.mark.parametrize("seed", (0, 1, 1234))
def test_random_draws_bit_equal(seed):
    """Random signs, random matrices and the ``randomize`` permutation
    come from the same numpy generator draws as the JAX package's."""
    for size in (64, 100):
        np.testing.assert_array_equal(
            th.random_hadamard_matrix(size, seed, device="cpu").numpy(),
            jh.random_hadamard_matrix(size, seed))
    np.testing.assert_array_equal(
        th.random_matrix(48, seed, device="cpu").numpy(),
        jh.random_matrix(48, seed))
    np.testing.assert_array_equal(
        th.random_matrix(48, seed, dtype=torch.float32, device="cpu").numpy(),
        jh.random_matrix(48, seed, dtype=np.float32))
    for type_ in ("hadamard", "random-hadamard"):
        scheme = dict(type=type_, randomize=True)
        got = ttr.TransformFactory.from_scheme(
            ttr.TransformScheme(**scheme), name="", seed=seed,
            device="cpu").get_weight(36)
        want = jtr.TransformFactory.from_scheme(
            jtr.TransformScheme(**scheme), name="", seed=seed).get_weight(36)
        np.testing.assert_array_equal(got.numpy(), want)


def test_creating_functions_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for fn in (lambda: th.hadamard_matrix(12),
               lambda: th.random_hadamard_matrix(8),
               lambda: th.random_matrix(8)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()


def test_high_precision_invert_and_multihead_matmul():
    M = th.random_matrix(32, 3, device="cpu")
    np.testing.assert_allclose((M @ th.high_precision_invert(M)).numpy(),
                               np.eye(32), atol=1e-10)
    rng = np.random.default_rng(0)
    A, B = rng.random((3, 4, 8)), rng.random((2, 2))
    np.testing.assert_allclose(
        ttr.multihead_matmul(torch.from_numpy(A), torch.from_numpy(B)).numpy(),
        jtr.multihead_matmul(A, B), rtol=1e-14)
    A2, B2 = rng.random((2, 2)), rng.random((8, 5))
    np.testing.assert_allclose(
        ttr.multihead_matmul(torch.from_numpy(A2),
                             torch.from_numpy(B2)).numpy(),
        jtr.multihead_matmul(A2, B2), rtol=1e-14)
    for args in (("Linear", "input", (64, 128)),
                 ("Linear", "weight_output", (64, 128)),
                 ("Embedding", "weight_output", (1000, 64)),
                 ("Embedding", "weight_input", (1000, 64))):
        assert ttr.get_transform_size(*args) == jtr.get_transform_size(*args)
    assert ttr.get_transform_size("Linear", "output", (64, 128),
                                  head_dim=16) == 16
    with pytest.raises(NotImplementedError):
        ttr.get_transform_size("LlamaAttention", "q_attn", None)


# --------------------------------------------------------------------------- #
# the correctness quartets, through the port


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _normalized(factory, size):
    w = factory.get_weight(size)
    return w / np.sqrt(size) if factory.normalize else w


def _inv(factory, w):
    return w.T if factory.normalize else ttr.high_precision_invert(w)


@pytest.mark.parametrize("type_", TYPES)
@pytest.mark.parametrize("randomize", (True, False))
@pytest.mark.parametrize("head_dim", (None, 2, 4))
@pytest.mark.parametrize("input_batch_size", (1, 5, 17))
def test_correctness_linear(rng, type_, randomize, head_dim,
                            input_batch_size):
    """y = x @ W.T is invariant under (x V^-1) @ (U^T (V W^T)) then U^-1."""
    W = _t(rng.standard_normal((4, 8)))
    factory = ttr.TransformFactory.from_scheme(
        ttr.TransformScheme(type=type_, randomize=randomize,
                            head_dim=head_dim), name="", seed=3,
        device="cpu")
    V = _normalized(factory, ttr.get_transform_size(
        "Linear", "input", W.shape, head_dim=head_dim))
    U = _normalized(factory, ttr.get_transform_size(
        "Linear", "output", W.shape, head_dim=head_dim))
    x = _t(rng.standard_normal((input_batch_size, 5, 8)))
    x_t = ttr.apply_transform_weight(_inv(factory, V), x, "input", "Linear")
    W_t = ttr.apply_transform_weight(V, W, "weight_input", "Linear")
    W_t = ttr.apply_transform_weight(U, W_t, "weight_output", "Linear")
    y = ttr.apply_transform_weight(_inv(factory, U), x_t @ W_t.T, "output",
                                   "Linear")
    np.testing.assert_allclose((x @ W.T).numpy(), y.numpy(), atol=1e-5,
                               rtol=0.0)


def _both(states, modules, config, seed):
    """apply_transform_config in both packages from the same numpy
    states; the port's results as numpy, checked against the JAX ones."""
    tstates = {n: {k: _t(v) for k, v in s.items()} for n, s in states.items()}
    got, tonline = ttr.apply_transform_config(
        tstates, {n: TInfo(i) for n, i in modules.items()},
        ttr.TransformConfig.model_validate(config), seed=seed)
    want, jonline = jtr.apply_transform_config(
        states, {n: JInfo(i) for n, i in modules.items()},
        jtr.TransformConfig.model_validate(config), seed=seed)
    out = {n: {k: v.numpy() for k, v in s.items()} for n, s in got.items()}
    for n, s in out.items():
        for k, v in s.items():
            np.testing.assert_allclose(v, want[n][k], rtol=1e-12, atol=1e-12)
    assert sorted(tonline) == sorted(jonline)
    return out, tonline


@pytest.mark.parametrize("type_", TYPES)
@pytest.mark.parametrize("randomize", (True, False))
def test_correctness_embedding(rng, type_, randomize):
    """Embedding -> Linear with a shared scheme: the rotation fused into the
    embedding's output cancels against the inverse in the linear's
    input."""
    emb, lin = rng.standard_normal((16, 4)), rng.standard_normal((8, 4))
    ids = rng.integers(0, 16, size=(17, 5))
    config = {"config_groups": {"": {
        "type": type_, "randomize": randomize,
        "apply": [{"targets": ["Embedding"], "location": "weight_output"},
                  {"targets": ["Linear"], "location": "weight_input",
                   "inverse": True}]}}}
    new, online = _both({"embed": {"weight": emb.copy()},
                         "linear": {"weight": lin.copy()}},
                        {"embed": "Embedding", "linear": "Linear"}, config,
                        11)
    assert not online
    np.testing.assert_allclose(emb[ids] @ lin.T, new["embed"]["weight"][ids]
                               @ new["linear"]["weight"].T, atol=1e-5,
                               rtol=0.0)


@pytest.mark.parametrize("type_", TYPES)
@pytest.mark.parametrize("randomize", (True, False))
@pytest.mark.parametrize("head_dim", (4, 8))
@pytest.mark.parametrize("bias", (False, True))
def test_correctness_attention_heads(rng, type_, randomize, head_dim, bias):
    """Per-head value/output rotation pairs cancel (with a v_proj bias
    rotated along, Qwen2-style)."""
    hidden = 2 * head_dim
    v_proj, o_proj = (rng.standard_normal((hidden, hidden)),
                      rng.standard_normal((hidden, hidden)))
    v_bias = rng.standard_normal(hidden) if bias else np.zeros(hidden)
    x = rng.standard_normal((5, hidden))
    v_state = {"weight": v_proj.copy(), **({"bias": v_bias} if bias else {})}
    config = {"config_groups": {"": {
        "type": type_, "randomize": randomize, "head_dim": head_dim,
        "apply": [{"targets": ["v_proj"], "location": "weight_output"},
                  {"targets": ["o_proj"], "location": "weight_input",
                   "inverse": True}]}}}
    new, _ = _both({"v_proj": v_state, "o_proj": {"weight": o_proj.copy()}},
                   {"v_proj": "Linear", "o_proj": "Linear"}, config, 5)
    out = (x @ new["v_proj"]["weight"].T
           + new["v_proj"].get("bias", 0)) @ new["o_proj"]["weight"].T
    np.testing.assert_allclose((x @ v_proj.T + v_bias) @ o_proj.T, out,
                               atol=1e-5, rtol=0.0)


@pytest.mark.parametrize("type_", TYPES)
def test_correctness_linear_with_bias(rng, type_):
    """WEIGHT_OUTPUT also rotates the bias: y' = (UW)x + Ub."""
    W, b = rng.standard_normal((8, 8)), rng.standard_normal(8)
    down, x = rng.standard_normal((8, 8)), rng.standard_normal((5, 8))
    config = {"config_groups": {"": {"type": type_, "apply": [
        {"targets": ["up"], "location": "weight_output"},
        {"targets": ["down"], "location": "weight_input", "inverse": True}]}}}
    new, _ = _both({"up": {"weight": W.copy(), "bias": b.copy()},
                    "down": {"weight": down.copy()}},
                   {"up": "Linear", "down": "Linear"}, config, 9)
    out = (x @ new["up"]["weight"].T + new["up"]["bias"]) @ \
        new["down"]["weight"].T
    np.testing.assert_allclose(out, (x @ W.T + b) @ down.T, atol=1e-5,
                               rtol=0.0)


@pytest.mark.parametrize("type_", ("hadamard", "random-hadamard"))
@pytest.mark.parametrize("randomize", (True, False))
@pytest.mark.parametrize("head_dim", (4, 8))
def test_correctness_query_key_locations(rng, type_, randomize, head_dim):
    """Online q_attn/k_cache specs: rotating q and k by the same
    orthonormal per-head transform leaves the scores invariant; the specs
    equal the JAX package's."""
    seq, heads = 5, 2
    hidden = heads * head_dim
    q, k = rng.standard_normal((seq, hidden)), rng.standard_normal(
        (seq, hidden))
    config = {"config_groups": {"": {
        "type": type_, "randomize": randomize, "head_dim": head_dim,
        "apply": [{"targets": ["LlamaAttention"], "location": "q_attn"},
                  {"targets": ["LlamaAttention"], "location": "k_cache"}]}}}
    _, online = ttr.apply_transform_config(
        {"attn": {}}, {"attn": TInfo("LlamaAttention")},
        ttr.TransformConfig.model_validate(config), seed=9, device="cpu")
    _, jonline = jtr.apply_transform_config(
        {"attn": {}}, {"attn": JInfo("LlamaAttention")},
        jtr.TransformConfig.model_validate(config), seed=9)
    assert [t.location for t in online["attn"]] == \
        [t.location for t in jonline["attn"]] == ["q_attn", "k_cache"]

    def heads_of(x):
        return x.reshape(seq, heads, head_dim).transpose(1, 0, 2)

    def rotate(x, t):
        return (ttr.multihead_matmul(_t(x).float().reshape(
            seq, heads, head_dim), t.weight) * t.scale).reshape(
            seq, hidden).double().numpy()

    for t, j in zip(online["attn"], jonline["attn"]):
        np.testing.assert_array_equal(t.weight.numpy(), j.weight)
    qt, kt = (rotate(x, t) for x, t in zip((q, k), online["attn"]))
    np.testing.assert_allclose(
        heads_of(q) @ heads_of(k).transpose(0, 2, 1),
        heads_of(qt) @ heads_of(kt).transpose(0, 2, 1), atol=1e-4, rtol=0.0)


# --------------------------------------------------------------------------- #
# the tiny Llama


def _dense_llama(seed=0):
    """name -> f32 weight of the tiny Llama (embedding, every linear, the
    lm_head) and its unit norms (a residual rotation is exact only through
    an RMSNorm whose weight is all ones)."""
    rng = np.random.default_rng(seed)
    H, I, V = CFG["hidden_size"], CFG["intermediate_size"], CFG["vocab_size"]
    NH, KVH, D = (CFG["num_attention_heads"], CFG["num_key_value_heads"],
                  CFG["head_dim"])
    shapes = {"model.embed_tokens": (V, H)}
    extra = {"model.norm.weight": np.ones(H, np.float32)}
    for i in range(CFG["num_hidden_layers"]):
        p = f"model.layers.{i}"
        shapes.update({f"{p}.self_attn.q_proj": (NH * D, H),
                       f"{p}.self_attn.k_proj": (KVH * D, H),
                       f"{p}.self_attn.v_proj": (KVH * D, H),
                       f"{p}.self_attn.o_proj": (H, NH * D),
                       f"{p}.mlp.gate_proj": (I, H),
                       f"{p}.mlp.up_proj": (I, H),
                       f"{p}.mlp.down_proj": (H, I)})
        for norm in ("input_layernorm", "post_attention_layernorm"):
            extra[f"{p}.{norm}.weight"] = np.ones(H, np.float32)
    shapes["lm_head"] = (V, H)
    weights = {n: (rng.normal(size=s) * 0.05).astype(np.float32)
               for n, s in shapes.items()}
    return weights, extra


def _within_one_ulp(got, want, dtype):
    """Elements of ``got`` more than one ``dtype`` ulp from ``want`` (both
    as f32 numpy), and the count that differ at all."""
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)).astype(np.float32))
    if dtype == torch.bfloat16:
        ulp = ulp * 2.0**16
    diff = np.abs(got - want)
    return int((diff > ulp).sum()), int((diff > 0).sum())


@pytest.fixture(scope="module")
def tiny_rotated():
    weights, extra = _dense_llama()
    return weights, extra


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_spinquant_on_tiny_llama_matches_jax(tiny_rotated, dtype):
    """R1 + R2 (with online R3/R4 entries) fused into the tiny Llama by
    both packages: every fused weight within one ulp of the JAX one, the
    online specs equal (location, module type, weight bits, scale,
    precision), the caller's dict and tensors untouched."""
    weights, _ = tiny_rotated
    config = spinquant_config(CFG["head_dim"], online=True)
    tmods = tct.module_graph_from_names(list(weights))
    jmods = jct.module_graph_from_names(list(weights))
    tw = {n: {"weight": torch.from_numpy(w).to(dtype)}
          for n, w in weights.items()}
    before = {n: s["weight"].clone() for n, s in tw.items()}
    got, tonline = ttr.apply_transform_config(
        tw, tmods, ttr.TransformConfig.model_validate(config))
    jdtype = np.float32 if dtype == torch.float32 else jnp.bfloat16
    want, jonline = jtr.apply_transform_config(
        {n: {"weight": np.asarray(jnp.asarray(w, jdtype))}
         for n, w in weights.items()}, jmods,
        jtr.TransformConfig.model_validate(config))
    for n, s in tw.items():
        assert torch.equal(s["weight"], before[n]) and len(s) == 1
    changed = 0
    for n in weights:
        g = got[n]["weight"]
        assert g.dtype == dtype
        bad, differ = _within_one_ulp(to_numpy(g), to_numpy(want[n]["weight"]),
                                      dtype)
        assert bad == 0, (n, bad, differ)
        changed += not torch.equal(g, tw[n]["weight"])
    assert changed == len(weights)
    assert sorted(tonline) == sorted(jonline)
    assert len(tonline) == 2 * CFG["num_hidden_layers"]
    for n, specs in tonline.items():
        for t, j in zip(specs, jonline[n], strict=True):
            assert (t.location, t.module_type, t.scale) == \
                (j.location, j.module_type, j.scale)
            assert str(t.precision).removeprefix("torch.") == \
                str(j.precision)
            np.testing.assert_array_equal(to_numpy(t.weight),
                                          to_numpy(j.weight))


def _save(path, states, modules, extra, qconfig=None, tconfig=None):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(CFG, f)
    tct.ModelCompressor(quantization_config=qconfig,
                        transform_config=tconfig).save_checkpoint(
        path, states, modules,
        extra_tensors={k: torch.from_numpy(v) for k, v in extra.items()})


def _ids():
    return np.random.default_rng(3).integers(0, CFG["vocab_size"],
                                             size=(2, 24))


def _torch_logits(path):
    params, config, _ = tl.load_llama_params(path, dtype=torch.float32,
                                             device="cpu")
    ids = _ids()
    pos = np.broadcast_to(np.arange(ids.shape[1]), ids.shape)
    out, _ = tl.llama_forward(params, config, torch.from_numpy(ids),
                              torch.from_numpy(np.array(pos)))
    return to_numpy(out)


def _jax_logits(path):
    params, config, _ = jl.load_llama_params(path, dtype=jnp.float32,
                                             use_kernels=False)
    ids = _ids()
    pos = np.broadcast_to(np.arange(ids.shape[1]), ids.shape)
    out, _ = jl.llama_forward(params, config, jnp.asarray(ids),
                              jnp.asarray(pos), use_kernels=False)
    return np.asarray(out)


def test_rotated_tiny_model_saved_and_read_by_both(tiny_rotated, tmp_path):
    """The rotated f32 model computes the unrotated one's function (both
    dense, saved by the port with their transform_config and read back);
    then quantized to W4A16 g128 by the port's lifecycle, saved with the
    transform_config, and read by both packages: logits within 1e-3 of
    max|ref| of each other."""
    weights, extra = tiny_rotated
    modules = tct.module_graph_from_names(list(weights))
    config = spinquant_config(CFG["head_dim"])
    tconfig = ttr.TransformConfig.model_validate(config)
    rotated, online = ttr.apply_transform_config(
        {n: {"weight": torch.from_numpy(w)} for n, w in weights.items()},
        modules, tconfig)
    assert not online
    _save(str(tmp_path / "dense"), {n: {"weight": torch.from_numpy(w)}
                                    for n, w in weights.items()},
          modules, extra)
    _save(str(tmp_path / "rotated"), rotated, modules, extra,
          tconfig=tconfig)
    with open(tmp_path / "rotated" / "config.json") as f:
        assert json.load(f)["quantization_config"]["transform_config"] == \
            tconfig.model_dump(mode="json")
    ref = _torch_logits(str(tmp_path / "dense"))
    got = _torch_logits(str(tmp_path / "rotated"))
    np.testing.assert_allclose(got, ref, atol=1e-3 * np.abs(ref).max(),
                               rtol=0)
    assert np.abs(got - ref).max() > 0  # the weights did change

    qconfig = tct.QuantizationConfig.model_validate(
        {"config_groups": {"W4A16": ["Linear"]}, "ignore": ["lm_head"]})
    states = tlc.apply_quantization_config(
        modules, {n: tuple(w.shape) for n, w in weights.items()}, qconfig,
        device="cpu")
    for name, state in states.items():
        tlc.calibrate_module(state, rotated[name]["weight"])
    path = str(tmp_path / "w4")
    _save(path, {n: {"weight": s["weight"],
                     **(states[n].qparams if n in states else {})}
                 for n, s in rotated.items()}, modules, extra, qconfig,
          tconfig)
    want = _jax_logits(path)
    got = _torch_logits(path)
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max(),
                               rtol=0)


def test_online_transform_refused_where_jax_engine_ignores_it(tiny_rotated,
                                                              tmp_path):
    """Reference caveat: no engine of either package applies an online
    transform, and the JAX ``from_compression_config`` drops the
    checkpoint's ``transform_config``. So the JAX package loads a
    checkpoint that needs an online rotation and runs it without one
    (silently wrong); the port refuses it with NotImplementedError. A
    checkpoint whose transforms are all ``weight_*`` loads in both."""
    weights, extra = tiny_rotated
    modules = tct.module_graph_from_names(list(weights))
    path = str(tmp_path / "online")
    _save(path, {n: {"weight": torch.from_numpy(w)}
                 for n, w in weights.items()}, modules, extra,
          tconfig=ttr.TransformConfig.model_validate(
              spinquant_config(CFG["head_dim"], online=True)))
    with pytest.raises(NotImplementedError,
                       match="no engine of either package"):
        tl.load_llama_params(path, dtype=torch.float32, device="cpu")
    logits = _jax_logits(path)  # loads, and runs without the rotations
    assert np.isfinite(logits).all()
    qc = jct.ModelCompressor.from_pretrained(path)
    assert qc is None or qc.transform_config is None


@pytest.mark.parametrize("where", ["block", "scheme", "args"])
def test_transform_block_with_unknown_keys_loads_as_in_jax(tiny_rotated,
                                                           tmp_path, where):
    """The JAX ``from_compression_config`` drops ``transform_config``
    unread, so a block that ``TransformConfig`` would not validate (here an
    unknown key at ``where``) loads there; the port reads only its
    locations, so it loads too, and an online location in such a block is
    still refused."""
    weights, extra = tiny_rotated
    modules = tct.module_graph_from_names(list(weights))
    path = str(tmp_path / "weights_only")
    _save(path, {n: {"weight": torch.from_numpy(w)}
                 for n, w in weights.items()}, modules, extra,
          tconfig=ttr.TransformConfig.model_validate(
              spinquant_config(CFG["head_dim"])))
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    block = cfg["quantization_config"]["transform_config"]
    {"block": block, "scheme": block["config_groups"]["R1"],
     "args": block["config_groups"]["R1"]["apply"][0]}[where][
        "unknown_key"] = 1
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    with pytest.raises(ValueError):
        ttr.TransformConfig.model_validate(block)
    assert np.isfinite(_jax_logits(path)).all()
    compressor = tct.ModelCompressor.from_pretrained(path)
    assert compressor is None or compressor.transform_config is None
    np.testing.assert_allclose(_torch_logits(path), _jax_logits(path),
                               atol=1e-3 * np.abs(_jax_logits(path)).max(),
                               rtol=0)

    block["config_groups"]["R1"]["apply"].append(
        {"targets": ["re:.*down_proj$"], "location": "input"})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    with pytest.raises(NotImplementedError,
                       match="no engine of either package"):
        tl.load_llama_params(path, dtype=torch.float32, device="cpu")
