"""Per-layer mixed schemes (BASELINE config 5's W4A16/W8A8 mix), TinyLlama
W8A8-int in every linear (BASELINE config 2) and post-RoPE query
quantization (``q_scale``) in the PyTorch port against the JAX package, on
the CPU in f32: the synthetic draws weight for weight, checkpoints written
by the port's ``save_llama_checkpoint`` and loaded by both packages,
logits (the port's kernel path through the kernels' plain versions, and
its non-kernel path, against the JAX non-kernel path) and greedy tokens
equal.

Logits agree within 1e-3 * max|logits| where no activation is quantized
to int8 (W4A16 layers, q_scale). A W8A8 linear rounds each token's
activations to int8 steps of absmax / 127.5; the two packages reach those
activations one f32 ulp apart (another summation order in the matmuls,
norms and attention), and an activation that sits on a rounding boundary
then takes codes one step apart, which moves it by up to 1/127.5 of its
row's absmax (0.78%). Models with W8A8 layers are held to 1e-2 *
max|logits| against the JAX package, and to 1e-5 between the port's own
kernel and non-kernel paths, whose activations and codes are the same;
their greedy tokens are equal up to a step where the JAX logits hold the
two packages' tokens within that 1e-2 (a near tie)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compressed_tensors_tpu.engine import greedy_generate as j_generate
from compressed_tensors_tpu.models import llama as jl
from compressed_tensors_tpu.models.config import LlamaConfig as JConfig
from compressed_tensors_tpu.models.synthetic import (
    make_synthetic_llama as j_synthetic,
)

from compressed_tensors_tpu_torch.engine import greedy_generate
from compressed_tensors_tpu_torch.interop import params_from_numpy
from compressed_tensors_tpu_torch.models import llama as tl
from compressed_tensors_tpu_torch.models.config import LlamaConfig
from compressed_tensors_tpu_torch.models.synthetic import (
    make_synthetic_llama,
    save_llama_checkpoint,
)
from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers
from compressed_tensors_tpu_torch.ops.linear import QuantizedTensor

from torch_port_utils import jax_params_to_numpy, to_numpy

SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
             num_hidden_layers=2, num_attention_heads=8,
             num_key_value_heads=2, head_dim=32)
MIXED = ["W4A16", "W8A8"]


def _ids(B, S, seed=1):
    return np.random.default_rng(seed).integers(0, 512, size=(B, S))


def _close(got, want, rel=1e-3):
    want = to_numpy(want)
    np.testing.assert_allclose(to_numpy(got), want,
                               atol=rel * np.abs(want).max(), rtol=0)


# a W8A8 model against the JAX package: one int8 step of a row's absmax
INT8_ACTS = 1e-2


def _logits(params, config, ids, package, use_kernels=False):
    pos = np.broadcast_to(np.arange(ids.shape[1]), ids.shape)
    if package == "jax":
        return jl.llama_forward(params, config, jnp.asarray(ids),
                                jnp.asarray(pos), use_kernels=False)[0]
    return tl.llama_forward(params, config, torch.from_numpy(ids),
                            torch.from_numpy(np.array(pos)),
                            use_kernels=use_kernels)[0]


def _tokens_match(jp, jc, tp, tc, ids, new=6, near_tie=None):
    """Greedy tokens of both packages equal; with ``near_tie``, a row may
    part where the JAX logits put its token and the port's within
    ``near_tie`` * max|logits| of each other (the rest of the row then
    continues from different tokens and is not compared)."""
    want = np.asarray(j_generate(jp, jc, jnp.asarray(ids), max_new_tokens=new,
                                 dtype=jnp.float32, use_kernels=False))
    got = greedy_generate(fuse_llama_layers(tp), tc, ids, max_new_tokens=new,
                          dtype=torch.float32, device="cpu").numpy()
    if near_tie is None:
        np.testing.assert_array_equal(got, want)
        return
    for row in range(ids.shape[0]):
        diff = np.flatnonzero(got[row] != want[row])
        if diff.size == 0:
            continue
        at = int(diff[0])
        logits = to_numpy(_logits(jp, jc, want[row:row + 1, :at],
                                  "jax"))[0, -1]
        margin = abs(logits[want[row, at]] - logits[got[row, at]])
        assert margin <= near_tie * np.abs(logits).max(), (row, at, margin)


def _saved(tmp_path, params, config):
    """``params`` written by the port, loaded by both packages (f32; the
    port with its kernel layouts). The synthetic bf16 group scales are
    written as f32 (the same values): the JAX non-kernel path dequantizes
    in the scale's dtype, the kernel paths in f32."""
    for layer in params["layers"]:
        for qt in layer.values():
            if isinstance(qt, QuantizedTensor) and qt.scale is not None:
                qt.scale = qt.scale.to(torch.float32)
    save_llama_checkpoint(params, config, str(tmp_path))
    jp, jc, _ = jl.load_llama_params(str(tmp_path), dtype=jnp.float32,
                                     use_kernels=False)
    tp, tc, _ = tl.load_llama_params(str(tmp_path), dtype=torch.float32,
                                     device="cpu")
    return jp, jc, tp, tc


def test_layer_presets_draw_matches_jax():
    """The same seed and presets give both packages the same per-layer
    weights, drawn in the same order."""
    jp = j_synthetic(JConfig(**SMALL), seed=3, dtype=jnp.float32,
                     use_kernels=False, layer_presets=MIXED,
                     lm_head_preset="W8A8")
    tp = params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    ours = make_synthetic_llama(LlamaConfig(**SMALL), seed=3,
                                dtype=torch.float32, device="cpu",
                                use_kernels=False, layer_presets=MIXED,
                                lm_head_preset="W8A8")
    for i, preset_bits in enumerate((4, 8)):
        for name in ("q_proj", "down_proj"):
            a, b = ours["layers"][i][name], tp["layers"][i][name]
            assert a.scheme.weights.num_bits == preset_bits
            leaf = "weight_packed" if preset_bits == 4 else "weight"
            assert torch.equal(getattr(a, leaf), getattr(b, leaf))
            assert torch.equal(a.scale, b.scale)
    assert tp["layers"][0]["o_proj"].kernel_meta[0] == "w4a16"
    assert tp["layers"][1]["o_proj"].kernel_meta[0] == "w8a8"
    assert torch.equal(ours["lm_head"].weight, tp["lm_head"].weight)
    ids = _ids(2, 12)
    _close(_logits(tp, LlamaConfig(**SMALL), ids, "torch"),
           _logits(jp, JConfig(**SMALL), ids, "jax"), INT8_ACTS)


def test_mixed_checkpoint_loads_in_both(tmp_path):
    """One config group per layer set (``re:`` targets over the layer
    indices, the lm_head its own): both loaders resolve every module to
    the scheme it was drawn with."""
    config = LlamaConfig(**SMALL)
    params = make_synthetic_llama(config, seed=4, dtype=torch.float32,
                                  device="cpu", use_kernels=False,
                                  layer_presets=MIXED, lm_head_preset="W8A8")
    jp, jc, tp, tc = _saved(tmp_path, params, config)
    for i, (bits, kind) in enumerate(((4, "w4a16"), (8, "w8a8"))):
        for name in ("k_proj", "up_proj"):
            assert jp["layers"][i][name].scheme.weights.num_bits == bits
            assert tp["layers"][i][name].scheme.weights.num_bits == bits
            assert tp["layers"][i][name].kernel_meta[0] == kind
    assert tp["lm_head"].scheme.targets == ["lm_head"]
    ids = _ids(2, 20, seed=2)
    want = _logits(jp, jc, ids, "jax")
    got = _logits(tp, tc, ids, "torch", use_kernels=True)
    _close(got, want, INT8_ACTS)
    _close(got, _logits(tp, tc, ids, "torch"), 1e-5)
    _tokens_match(jp, jc, tp, tc, ids[:, :12], near_tie=INT8_ACTS)


def test_w8a8_int_model_matches_jax(tmp_path):
    """BASELINE config 2: W8A8-int (per-channel int8 weights, dynamic
    per-token int8 activations) in every linear and the lm_head."""
    config = LlamaConfig(**SMALL)
    params = make_synthetic_llama(config, "W8A8", seed=6, dtype=torch.float32,
                                  device="cpu", use_kernels=False,
                                  lm_head_preset="W8A8")
    jref = j_synthetic(JConfig(**SMALL), "W8A8", seed=6, dtype=jnp.float32,
                       use_kernels=False, lm_head_preset="W8A8")
    assert torch.equal(params["layers"][1]["gate_proj"].weight,
                       torch.from_numpy(np.array(
                           jref["layers"][1]["gate_proj"].weight)))
    jp, jc, tp, tc = _saved(tmp_path, params, config)
    assert all(qt.kernel_meta[0] == "w8a8" for layer in tp["layers"]
               for qt in layer.values() if hasattr(qt, "kernel_meta"))
    ids = _ids(2, 20, seed=3)
    want = _logits(jp, jc, ids, "jax")
    got = _logits(tp, tc, ids, "torch", use_kernels=True)
    _close(got, want, INT8_ACTS)
    _close(got, _logits(tp, tc, ids, "torch"), 1e-5)
    _tokens_match(jp, jc, tp, tc, ids[:, :12], near_tie=INT8_ACTS)


@pytest.mark.parametrize("per_head", [False, True])
def test_q_scale_matches_jax(tmp_path, per_head):
    """q_scale written beside k/v scales and loaded by both packages: the
    fp8 fake-quant of q after RoPE (per tensor, or per query head)."""
    config = LlamaConfig(**SMALL)
    params = make_synthetic_llama(config, seed=7, dtype=torch.float32,
                                  device="cpu", use_kernels=False)
    H = config.num_attention_heads
    plain = _logits(params, config, _ids(2, 16, seed=4), "torch")
    for layer in params["layers"]:
        layer["q_scale"] = (torch.linspace(2e-3, 6e-3, H).reshape(H, 1, 1)
                            if per_head else torch.tensor([4e-3]))
    jp, jc, tp, tc = _saved(tmp_path, params, config)
    assert tuple(tp["layers"][0]["q_scale"].shape) == (
        (H, 1, 1) if per_head else (1,))
    ids = _ids(2, 16, seed=4)
    want = _logits(jp, jc, ids, "jax")
    got = _logits(tp, tc, ids, "torch", use_kernels=True)
    _close(got, want)
    _close(_logits(tp, tc, ids, "torch"), want)
    # the fake-quant moves the logits ten times further than the packages
    # stand apart
    got, want, plain = to_numpy(got), to_numpy(want), to_numpy(plain)
    assert np.abs(got - plain).max() > 10 * np.abs(got - want).max()
    _tokens_match(jp, jc, tp, tc, ids[:, :10])
