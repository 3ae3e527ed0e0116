"""The Qwen family in the PyTorch port against the JAX package, in f32 on
the CPU: the Qwen2 qkv bias and the Qwen3 per-head q/k RMSNorm, through
checkpoint -> load -> fuse -> forward, greedy decode and serving.

Tiny ``qwen2`` (W4A16 asymmetric g32, the AWQ kind) and ``qwen3`` (W4A16
symmetric g32) checkpoints from ``make_tiny_llama_checkpoint``, as
``tests/test_models/test_qwen.py`` builds them, at hidden 256 and
intermediate 448 (so down_proj's K = 448 pads to the plane layout's
k-tile of 512). The checkpoint's q/k norm weights are ones; both packages
then get the same random ones, so that a skipped norm shows.

- The default layout: logits within 1e-3 * max|logits| of the JAX
  package, greedy tokens equal (params loaded by the port, and carried
  over from the JAX params with ``params_from_numpy``).
- ``w4_layout="packed"`` in each ``w4_mode``, against the JAX non-kernel
  path (the JAX kernel path raises there, ROADMAP C): ``int4`` and
  ``mat`` within 1e-3 * max|logits| with greedy tokens equal (in f32 both
  compute the same products); ``a8`` rounds every linear's input to int8
  per row (steps of max|x|/127), held to 5e-2 * max|logits| (2.3-2.6%
  read here).
- One paged ``ServingEngine`` run under "packed" against the JAX engine.
- ``w4_layout="e8"``: symmetric weights take the grouped-int8 kernel,
  weights with zero points fall through to the plane layout.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compressed_tensors_tpu.engine import (
    Request as JRequest,
    ServingEngine as JEngine,
    greedy_generate as j_generate,
    make_step_fns as j_steps,
)
from compressed_tensors_tpu.models import llama as jl
from compressed_tensors_tpu.models.config import LlamaConfig as JConfig
from testing_utils import make_tiny_llama_checkpoint

from compressed_tensors_tpu_torch.engine import (
    Request,
    ServingEngine,
    greedy_generate,
    make_step_fns,
)
from compressed_tensors_tpu_torch.flags import flag_overrides
from compressed_tensors_tpu_torch.interop import params_from_numpy
from compressed_tensors_tpu_torch.models import llama as tl
from compressed_tensors_tpu_torch.models.config import LlamaConfig
from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers
from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as tw

from torch_port_utils import (
    TORCH_TINY_CONFIG,
    jax_params_to_numpy,
    to_numpy,
    w4a16_config,
)

QWEN = {
    "qwen2": (["Qwen2ForCausalLM"], False),  # (architectures, symmetric)
    "qwen3": (["Qwen3ForCausalLM"], True),
    "llama": (["LlamaForCausalLM"], True),
}
TOL = {"int4": 1e-3, "mat": 1e-3, "a8": 5e-2}


def _config(model_type):
    cfg = dict(TORCH_TINY_CONFIG, model_type=model_type,
               architectures=QWEN[model_type][0], intermediate_size=448)
    return cfg


def test_config_flags_match_jax():
    for model_type in ("qwen2", "qwen3", "llama"):
        cfg = _config(model_type)
        got, want = LlamaConfig.from_dict(cfg), JConfig.from_dict(cfg)
        assert (got.attention_bias, got.qk_norm) == (want.attention_bias,
                                                     want.qk_norm)
    assert LlamaConfig.from_dict(_config("qwen2")).attention_bias
    assert LlamaConfig.from_dict(_config("qwen3")).qk_norm


def _random_norms(jp, tps, rng, head_dim):
    """The same random q/k norm weights, 1 + N(0, 0.1^2), in the JAX params
    and in each port params tree of ``tps``."""
    for i, layer in enumerate(jp["layers"]):
        for name in ("q_norm", "k_norm"):
            w = (1 + 0.1 * rng.standard_normal(head_dim)).astype(np.float32)
            layer[name] = jnp.asarray(w)
            for tp in tps:
                tp["layers"][i][name] = torch.from_numpy(w.copy())


@pytest.fixture(scope="module", params=["qwen2", "qwen3"])
def qwen(request, tmp_path_factory):
    """(model_type, JAX params and config, port params under the default
    and the "packed" layout (fused), port config, the checkpoint)."""
    model_type = request.param
    path, states = make_tiny_llama_checkpoint(
        pathlib.Path(tmp_path_factory.mktemp(model_type)),
        np.random.default_rng(0),
        w4a16_config(symmetric=QWEN[model_type][1], group_size=32),
        model_config=_config(model_type))
    jp, jc, _ = jl.load_llama_params(path, dtype=jnp.float32,
                                     use_kernels=False)
    tp, tc, _ = tl.load_llama_params(path, dtype=torch.float32, device="cpu")
    with flag_overrides(w4_layout="packed"):
        tpp, _, _ = tl.load_llama_params(path, dtype=torch.float32,
                                         device="cpu")
    layer = tp["layers"][0]
    if model_type == "qwen2":
        bias = states["model.layers.0.self_attn.q_proj"]["bias"]
        np.testing.assert_allclose(layer["q_proj"].bias.numpy(),
                                   np.asarray(bias), atol=1e-6)
        np.testing.assert_array_equal(
            layer["q_proj"].bias.numpy(),
            np.asarray(jp["layers"][0]["q_proj"].bias))
        assert "q_norm" not in layer
    else:
        assert layer["q_proj"].bias is None
        np.testing.assert_array_equal(layer["q_norm"].numpy(),
                                      np.ones(tc.head_dim, np.float32))
        np.testing.assert_array_equal(layer["k_norm"].numpy(),
                                      np.asarray(jp["layers"][0]["k_norm"]))
        _random_norms(jp, (tp, tpp), np.random.default_rng(1), tc.head_dim)
    assert tpp["layers"][0]["down_proj"].kernel_meta == (
        "w4packed", 256, 448, 32)
    tpp = fuse_llama_layers(tpp)
    assert {qt.kernel_meta[0] for layer in tpp["layers"]
            for qt in layer.values() if hasattr(qt, "kernel_meta")} == {
                "w4packed"}
    return model_type, jp, jc, fuse_llama_layers(tp), tpp, tc, path


def _ids(B, S, seed):
    return np.random.default_rng(seed).integers(0, 512, size=(B, S))


def _prefill_logits(jp, jc, tp, tc, ids):
    want = j_steps(jc, 32, dtype=jnp.float32, use_kernels=False)[0](
        jp, jnp.asarray(ids, jnp.int32), ids.shape[1])[2]
    got = make_step_fns(tc, 32, dtype=torch.float32, device="cpu")[0](
        tp, torch.from_numpy(ids), ids.shape[1])[2]
    return to_numpy(got), to_numpy(want)


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_qwen_logits_and_greedy_match_jax(qwen):
    model_type, jp, jc, tp, _, tc, _ = qwen
    fused = tp["layers"][0]
    assert "qkv_proj" in fused and "gate_up_proj" in fused
    assert (fused["qkv_proj"].bias is not None) == (model_type == "qwen2")
    ids = _ids(2, 12, seed=2)
    _close(*_prefill_logits(jp, jc, tp, tc, ids), 1e-3)
    want = np.asarray(j_generate(jp, jc, jnp.asarray(ids, jnp.int32),
                                 max_new_tokens=6, dtype=jnp.float32,
                                 use_kernels=False))
    got = greedy_generate(tp, tc, ids, max_new_tokens=6, dtype=torch.float32,
                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    # the same model carried over from the JAX params
    carried = fuse_llama_layers(params_from_numpy(jax_params_to_numpy(jp),
                                                  device="cpu"))
    got = greedy_generate(carried, tc, ids, max_new_tokens=6,
                          dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["int4", "a8", "mat"])
def test_qwen_packed_modes_match_jax(qwen, mode, monkeypatch):
    _, jp, jc, _, tpp, tc, _ = qwen
    calls = []
    plain = tw.w4a16_planes_matmul_plain

    def counted(*args, **kwargs):
        calls.append(kwargs["mode"])
        return plain(*args, **kwargs)

    monkeypatch.setattr(tw, "w4a16_planes_matmul_plain", counted)
    ids = _ids(2, 12, seed=3)
    with flag_overrides(w4_mode=mode):
        got, want = _prefill_logits(jp, jc, tpp, tc, ids)
        _close(got, want, TOL[mode])
        assert calls and set(calls) == {mode}
        if mode != "a8":
            want = np.asarray(j_generate(
                jp, jc, jnp.asarray(ids, jnp.int32), max_new_tokens=5,
                dtype=jnp.float32, use_kernels=False))
            got = greedy_generate(tpp, tc, ids, max_new_tokens=5,
                                  dtype=torch.float32, device="cpu")
            np.testing.assert_array_equal(got.numpy(), want)


def test_qwen_paged_serving_matches_jax(qwen):
    _, jp, jc, _, tpp, tc, _ = qwen
    settings = dict(max_batch=2, max_len=32, prefill_chunk=8,
                    steps_per_sync=2, paged=True, page_size=8)
    j_eng = JEngine(jp, jc, dtype=jnp.float32, use_kernels=False, **settings)
    t_eng = ServingEngine(tpp, tc, dtype=torch.float32, device="cpu",
                          **settings)
    rng = np.random.default_rng(4)
    for rid, n in enumerate((9, 3, 6)):
        prompt = rng.integers(0, 512, size=n).tolist()
        j_eng.submit(JRequest(request_id=rid, prompt_ids=prompt,
                              max_new_tokens=5))
        t_eng.submit(Request(request_id=rid, prompt_ids=prompt,
                             max_new_tokens=5))
    want = {c.request_id: c.output_ids for c in j_eng.run()}
    with flag_overrides(w4_mode="int4"):
        got = {c.request_id: c.output_ids for c in t_eng.run()}
    assert got == want


def test_e8_layout_by_zero_points(qwen):
    """Under "e8" symmetric W4 takes the grouped-int8 kernel and W4 with
    zero points (qwen2) falls through to the plane layout and its kernel,
    as in the JAX package."""
    model_type, jp, jc, _, _, tc, path = qwen
    with flag_overrides(w4_layout="e8"):
        tp, _, _ = tl.load_llama_params(path, dtype=torch.float32,
                                        device="cpu")
    if model_type == "qwen3":
        _random_norms(jp, (tp,), np.random.default_rng(1), tc.head_dim)
    tp = fuse_llama_layers(tp)
    kinds = {qt.kernel_meta[0] for layer in tp["layers"]
             for qt in layer.values() if hasattr(qt, "kernel_meta")}
    assert kinds == {"w4packed" if model_type == "qwen2" else "w4e8"}
    _close(*_prefill_logits(jp, jc, tp, tc, _ids(2, 12, seed=5)), 1e-3)
