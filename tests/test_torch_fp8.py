"""FP8 W8A8 with an FP8 (or int8) KV cache: the PyTorch port against the
JAX package, in f32 on the CPU.

- The port's synthetic FP8_DYNAMIC model draws the JAX package's weights
  and scales bit for bit, and JAX-built params (k/v scales included) carry
  over through ``params_from_numpy``.
- Under ``fp8_transcode="always"`` both packages re-grid fp8 weights to the
  same int8 kernel weights and scales.
- A tiny FP8_DYNAMIC checkpoint with per-tensor or per-head k/v scales,
  loaded by both packages: ``greedy_generate`` with an fp8 cache gives the
  same tokens, and the prefill logits agree within 1e-4 * max|logits|.
  Under ``fp8_transcode="always"`` the same holds for both packages' int8
  weights and int8 cache, with the prefill logits within 5e-2 *
  max|logits|.

The tolerances: the two packages take f32 sums in other orders, and the
port's kernels' plain versions fold the cache scales into q and the output
where the JAX non-kernel path dequantizes the cache; that moves values by
about 1e-6 of their size. An 8-bit activation that lies within that of a
rounding boundary rounds the other way in one package and moves the
logits of this tiny random model by 3-5% of their maximum. With int8
activations (about 127 steps) that happens on every prompt tried (10 of
10: 3-5%); with fp8 rarely (2 of 10 prompts; the others agree within
7e-7). The prompt below is one on which no such flip parts the greedy
tokens in any of the four cases.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compressed_tensors_tpu.engine import (
    greedy_generate as j_generate,
    make_step_fns as j_steps,
)
from compressed_tensors_tpu.flags import flag_overrides as j_flags
from compressed_tensors_tpu.models import llama as jl
from compressed_tensors_tpu.models.config import LlamaConfig as JConfig
from compressed_tensors_tpu.models.synthetic import (
    make_synthetic_llama as j_synthetic,
)
from compressed_tensors_tpu.ops.linear import (
    from_compressed_state as j_from_state,
    prepare_for_kernels as j_prepare,
    quantized_matmul as j_matmul,
)
from compressed_tensors_tpu.quantization import (
    preset_name_to_scheme as j_preset,
)
from testing_utils import make_tiny_llama_checkpoint

from compressed_tensors_tpu_torch.engine import greedy_generate, make_step_fns
from compressed_tensors_tpu_torch.flags import flag_overrides
from compressed_tensors_tpu_torch.interop import params_from_numpy
from compressed_tensors_tpu_torch.models import llama as tl
from compressed_tensors_tpu_torch.models.config import LlamaConfig
from compressed_tensors_tpu_torch.models.synthetic import make_synthetic_llama
from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers
from compressed_tensors_tpu_torch.ops.linear import (
    from_compressed_state,
    prepare_for_kernels,
    quantized_matmul,
)
from compressed_tensors_tpu_torch.quantization import preset_name_to_scheme

from torch_port_utils import (
    TORCH_TINY_CONFIG,
    fp8_dynamic_config,
    jax_params_to_numpy,
    raw_bytes,
    to_numpy,
    to_torch,
)

SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
             num_hidden_layers=2, num_attention_heads=8,
             num_key_value_heads=2, head_dim=32)
PROJS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
         "down_proj")


def test_synthetic_fp8_model_and_kv_scales_match_jax():
    jp = j_synthetic(JConfig(**SMALL), "FP8_DYNAMIC", seed=3,
                     dtype=jnp.float32, use_kernels=False,
                     lm_head_preset="W8A8")
    for layer in jp["layers"]:
        layer["k_scale"] = jnp.asarray([0.03], jnp.float32)
        layer["v_scale"] = jnp.asarray([0.05], jnp.float32)
    carried = params_from_numpy(jax_params_to_numpy(jp), device="cpu",
                                use_kernels=False)
    ours = make_synthetic_llama(LlamaConfig(**SMALL), "FP8_DYNAMIC", seed=3,
                                dtype=torch.float32, device="cpu",
                                use_kernels=False, lm_head_preset="W8A8")
    for mine, theirs in zip(ours["layers"], carried["layers"]):
        for proj in PROJS:
            a, b = mine[proj], theirs[proj]
            assert a.weight.dtype == b.weight.dtype == torch.float8_e4m3fn
            assert a.format == b.format == "float-quantized"
            np.testing.assert_array_equal(raw_bytes(a.weight),
                                          raw_bytes(b.weight))
            assert torch.equal(a.scale, b.scale)
        # k/v scales carry over as plain arrays
        assert torch.equal(theirs["k_scale"], torch.tensor([0.03]))
        assert torch.equal(theirs["v_scale"], torch.tensor([0.05]))
    assert torch.equal(ours["lm_head"].weight, carried["lm_head"].weight)
    assert torch.equal(ours["embed_tokens"], carried["embed_tokens"])


def test_fp8_transcode_regrids_weights_like_jax():
    rng = np.random.default_rng(0)
    n, k = 192, 256
    import ml_dtypes

    state = {"weight": rng.uniform(-400, 400, (n, k)).astype(
                 ml_dtypes.float8_e4m3fn),
             "weight_scale": rng.uniform(1e-3, 1e-2, (n, 1)).astype(
                 np.float32)}
    jqt = j_from_state({key: jnp.asarray(v) for key, v in state.items()},
                       j_preset("FP8_DYNAMIC", ["Linear"]))
    tqt = from_compressed_state({key: to_torch(v) for key, v in state.items()},
                                preset_name_to_scheme("FP8_DYNAMIC",
                                                      ["Linear"]))
    x = rng.standard_normal((3, k)).astype(np.float32)
    i = np.abs(x).argmax(-1)[:, None]  # positive row maxima (no -127.5 tie)
    np.put_along_axis(x, i, np.abs(np.take_along_axis(x, i, -1)), -1)
    with j_flags(fp8_transcode="always"), flag_overrides(
            fp8_transcode="always"):
        jk, tk = j_prepare(jqt), prepare_for_kernels(tqt)
    assert tk.kernel_packed.dtype == torch.int8
    np.testing.assert_array_equal(tk.kernel_packed.numpy(),
                                  np.asarray(jk.kernel_packed).T)
    np.testing.assert_array_equal(tk.kernel_scales.numpy(),
                                  np.asarray(jk.kernel_scales).reshape(-1))
    want = np.asarray(j_matmul(jnp.asarray(x), jk, use_kernels=True))
    got = quantized_matmul(torch.from_numpy(x), tk).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)
    with flag_overrides(fp8_transcode="never"):
        assert prepare_for_kernels(tqt).kernel_packed.dtype == \
            torch.float8_e4m3fn
    assert prepare_for_kernels(tqt).kernel_packed.dtype == \
        torch.float8_e4m3fn  # "auto": native fp8


@pytest.fixture(scope="module")
def fp8_checkpoints(tmp_path_factory):
    """Tiny FP8_DYNAMIC checkpoints with per-tensor and per-head k/v
    scales."""
    return {kv: make_tiny_llama_checkpoint(
        pathlib.Path(tmp_path_factory.mktemp(f"fp8-{kv}")),
        np.random.default_rng(0), fp8_dynamic_config(),
        model_config=TORCH_TINY_CONFIG, kv_scales=kv)[0]
        for kv in (True, "per_head")}


def _jax_reference(path, transcode):
    """The JAX package's params and cache dtype under ``transcode``, run
    on its non-kernel path. Under "always" each linear holds the int8
    weight and scale its ``prepare_for_kernels`` re-gridded (equal to the
    port's, see above) as an int8 W8A8 linear: its kernel path would run
    them through the Pallas kernel in interpret mode, which rounds the
    -127.5 ties of rows with a negative maximum otherwise than IEEE
    division (ROADMAP C)."""
    with j_flags(fp8_transcode=transcode):
        jp, jc, _ = jl.load_llama_params(path, dtype=jnp.float32,
                                         use_kernels=transcode == "always")
        jp, j_cache = jl.transcode_fp8_kv_to_int8(jp, jnp.float8_e4m3fn)
    if transcode == "always":
        int8 = j_preset("W8A8", ["Linear"])
        for layer in jp["layers"]:
            for proj in PROJS:
                qt = layer[proj]
                layer[proj] = dataclasses.replace(
                    qt, weight=qt.kernel_packed.T,
                    scale=qt.kernel_scales.reshape(-1, 1), scheme=int8,
                    format="int-quantized", kernel_packed=None,
                    kernel_scales=None, kernel_meta=None)
    return jp, jc, j_cache


@pytest.mark.parametrize("transcode", ["never", "always"])
@pytest.mark.parametrize("kv_scales", [True, "per_head"],
                         ids=["per-tensor", "per-head"])
def test_greedy_with_fp8_kv_cache_matches_jax(fp8_checkpoints, kv_scales,
                                              transcode):
    path = fp8_checkpoints[kv_scales]
    ids = np.random.default_rng(6).integers(0, 512, size=(2, 12))
    jp, jc, j_cache = _jax_reference(path, transcode)
    with flag_overrides(fp8_transcode=transcode):
        tp, tc, _ = tl.load_llama_params(path, dtype=torch.float32,
                                         device="cpu")
        tp, t_cache = tl.transcode_fp8_kv_to_int8(fuse_llama_layers(tp),
                                                  torch.float8_e4m3fn)
    assert t_cache == (torch.int8 if transcode == "always"
                       else torch.float8_e4m3fn)
    assert jnp.dtype(j_cache).name == str(t_cache).split(".")[-1]
    assert tp["layers"][0]["qkv_proj"].kernel_packed.dtype == (
        torch.int8 if transcode == "always" else torch.float8_e4m3fn)
    assert tp["layers"][0]["k_scale"].numel() == (
        1 if kv_scales is True else tc.num_key_value_heads)

    want = np.asarray(j_generate(jp, jc, jnp.asarray(ids, jnp.int32),
                                 max_new_tokens=6, dtype=jnp.float32,
                                 cache_dtype=j_cache, use_kernels=False))
    got = greedy_generate(tp, tc, ids, max_new_tokens=6, dtype=torch.float32,
                          cache_dtype=t_cache, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)

    _, _, j_logits = j_steps(jc, 18, dtype=jnp.float32, cache_dtype=j_cache,
                             use_kernels=False)[0](
        jp, jnp.asarray(ids, jnp.int32), 12)
    _, cache, t_logits = make_step_fns(tc, 18, dtype=torch.float32,
                                       cache_dtype=t_cache, device="cpu")[0](
        tp, torch.from_numpy(ids), 12)
    assert cache.k.dtype == t_cache
    want = to_numpy(j_logits)
    tol = 5e-2 if transcode == "always" else 1e-4
    np.testing.assert_allclose(to_numpy(t_logits), want,
                               atol=tol * np.abs(want).max(), rtol=0)
