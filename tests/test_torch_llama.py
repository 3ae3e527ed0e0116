"""The slice as a whole: a W4A16 group-128 Llama checkpoint loaded by the
JAX package and by the PyTorch port, compared in f32 on the CPU (logits
within 1e-3 * max|logits|, greedy tokens equal), plus the synthetic-model
bridges: JAX-built params carried over with ``params_from_numpy``, the
port's synthetic model and its checkpoint writer."""

import pathlib

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
from testing_utils import make_tiny_llama_checkpoint

from compressed_tensors_tpu_torch.engine import greedy_generate
from compressed_tensors_tpu_torch.interop import params_from_numpy
from compressed_tensors_tpu_torch.models import llama as tl
from compressed_tensors_tpu_torch.models.config import LlamaConfig
from compressed_tensors_tpu_torch.models.synthetic import (
    make_synthetic_llama,
    save_llama_checkpoint,
)
from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers

from torch_port_utils import (
    TORCH_TINY_CONFIG,
    jax_params_to_numpy,
    to_numpy,
    w4a16_config,
)


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """One tiny checkpoint, loaded by both packages (f32)."""
    path, _ = make_tiny_llama_checkpoint(
        pathlib.Path(tmp_path_factory.mktemp("ckpt")),
        np.random.default_rng(0), w4a16_config(),
        model_config=TORCH_TINY_CONFIG)
    jp, jc, _ = jl.load_llama_params(path, dtype=jnp.float32,
                                     use_kernels=False)
    tp, tc, _ = tl.load_llama_params(path, dtype=torch.float32, device="cpu")
    return jp, jc, tp, tc


def _ids(B, S, seed=1):
    return np.random.default_rng(seed).integers(0, 512, size=(B, S))


def _close_logits(got, want):
    want = to_numpy(want)
    np.testing.assert_allclose(to_numpy(got), want,
                               atol=1e-3 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_forward_logits_match(loaded, use_kernels):
    jp, jc, tp, tc = loaded
    ids = _ids(2, 80)
    pos = np.broadcast_to(np.arange(80), ids.shape)
    want, _ = jl.llama_forward(jp, jc, jnp.asarray(ids), jnp.asarray(pos),
                               use_kernels=False)
    got, cache = tl.llama_forward(tp, tc, torch.from_numpy(ids),
                                  torch.from_numpy(np.array(pos)),
                                  use_kernels=use_kernels)
    _close_logits(got, want)
    assert cache.lengths.tolist() == [80, 80]


@pytest.mark.parametrize("S", [16, 80])  # both fresh-prefill branches
def test_greedy_tokens_match(loaded, S):
    jp, jc, tp, tc = loaded
    ids = _ids(2, S, seed=S)
    want = np.asarray(j_generate(jp, jc, jnp.asarray(ids, jnp.int32),
                                 max_new_tokens=8, dtype=jnp.float32,
                                 use_kernels=False))
    got = greedy_generate(fuse_llama_layers(tp), tc, ids, max_new_tokens=8,
                          dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_tokens_match_with_flash_decode(loaded, monkeypatch):
    """decode_attn="flash" sends the small greedy cache (S_pad 64, where
    "auto" picks the block kernel) through flash decode."""
    from compressed_tensors_tpu_torch.flags import flag_overrides
    from compressed_tensors_tpu_torch.ops.kernels import flash_decode

    jp, jc, tp, tc = loaded
    ids = _ids(2, 16, seed=5)
    want = np.asarray(j_generate(jp, jc, jnp.asarray(ids, jnp.int32),
                                 max_new_tokens=6, dtype=jnp.float32,
                                 use_kernels=False))
    calls = []
    plain = flash_decode.flash_decode_attention_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(flash_decode, "flash_decode_attention_plain", counted)
    with flag_overrides(decode_attn="flash"):
        got = greedy_generate(fuse_llama_layers(tp), tc, ids,
                              max_new_tokens=6, dtype=torch.float32,
                              device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(calls) == 5 * tc.num_hidden_layers  # every decode step


def test_decode_step_with_packed_cache(loaded):
    """A prefill and one decode step in both packages (the port through its
    kernels' plain versions, the JAX package on its non-kernel path):
    logits, and the cache contents after mapping the JAX head-packed,
    lane-padded layout back to (L, B, KVH, S_pad, D)."""
    jp, jc, tp, tc = loaded
    B, S = 2, 12
    ids = _ids(B, S)
    pos = np.broadcast_to(np.arange(S), ids.shape)
    j_cache = jl.init_kv_cache(jc, B, 64, dtype=jnp.float32)
    assert j_cache.k.shape[2] < jc.num_key_value_heads  # heads are packed
    _, j_cache = jl.llama_forward(jp, jc, jnp.asarray(ids), jnp.asarray(pos),
                                  j_cache, fresh_prefill=True,
                                  use_kernels=False)
    t_cache = tl.init_kv_cache(tc, B, 64, dtype=torch.float32, device="cpu")
    _, t_cache = tl.llama_forward(tp, tc, torch.from_numpy(ids),
                                  torch.from_numpy(np.array(pos)), t_cache,
                                  fresh_prefill=True)

    tok = np.asarray([[7], [300]])
    step_pos = np.array(j_cache.lengths)[:, None]
    j_logits, j_cache = jl.llama_forward(jp, jc, jnp.asarray(tok),
                                         jnp.asarray(step_pos), j_cache,
                                         use_kernels=False)
    t_logits, t_cache = tl.llama_forward(tp, tc, torch.from_numpy(tok),
                                         torch.from_numpy(step_pos), t_cache)
    _close_logits(t_logits, j_logits)

    D = jc.head_dim
    P = jc.num_key_value_heads // j_cache.k.shape[2]
    slot = j_cache.k.shape[-1] // P
    for j_buf, t_buf in ((j_cache.k, t_cache.k), (j_cache.v, t_cache.v)):
        for layer in range(jc.num_hidden_layers):
            want = np.asarray(jl._unpack_kv_heads(j_buf[layer], P, slot, D))
            np.testing.assert_allclose(t_buf[layer].numpy(), want, atol=1e-5,
                                       rtol=0)
    np.testing.assert_array_equal(t_cache.lengths.numpy(),
                                  np.asarray(j_cache.lengths))


SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
             num_hidden_layers=2, num_attention_heads=8,
             num_key_value_heads=2, head_dim=32)


def test_params_from_numpy_gives_same_logits():
    # the synthetic scales are bf16, which the non-kernel paths of both
    # packages dequantize in (the kernel paths apply them in f32), so the
    # comparison runs both on the non-kernel path
    jc = JConfig(**SMALL)
    jp = j_synthetic(jc, "W4A16", seed=3, dtype=jnp.float32,
                     use_kernels=False, lm_head_preset="W8A8")
    tp = params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    ids = _ids(2, 20)
    pos = np.broadcast_to(np.arange(20), ids.shape)
    want, _ = jl.llama_forward(jp, jc, jnp.asarray(ids), jnp.asarray(pos),
                               use_kernels=False)
    got, _ = tl.llama_forward(tp, LlamaConfig(**SMALL), torch.from_numpy(ids),
                              torch.from_numpy(np.array(pos)),
                              use_kernels=False)
    _close_logits(got, want)

    # the port's own synthetic model draws the same weights from the seed
    ours = make_synthetic_llama(LlamaConfig(**SMALL), "W4A16", seed=3,
                                dtype=torch.float32, device="cpu",
                                lm_head_preset="W8A8")
    for name in ("qkv", "down_proj"):
        key = "q_proj" if name == "qkv" else name
        a, b = ours["layers"][1][key], tp["layers"][1][key]
        assert torch.equal(a.weight_packed, b.weight_packed)
        assert torch.equal(a.scale, b.scale)
    assert torch.equal(ours["lm_head"].weight, tp["lm_head"].weight)
    assert torch.equal(ours["embed_tokens"], tp["embed_tokens"])


def test_saved_synthetic_checkpoint_loads_in_both(tmp_path):
    config = LlamaConfig(**SMALL)
    params = make_synthetic_llama(config, "W4A16", seed=4, device="cpu",
                                  dtype=torch.float32, use_kernels=False,
                                  lm_head_preset="W8A8")
    save_llama_checkpoint(params, config, str(tmp_path))
    jp, jc, _ = jl.load_llama_params(str(tmp_path), dtype=jnp.float32,
                                     use_kernels=False)
    tp, tc, _ = tl.load_llama_params(str(tmp_path), dtype=torch.float32,
                                     device="cpu")
    assert tp["lm_head"].kernel_meta == ("w8a8", 512, 256)
    assert tp["layers"][0]["q_proj"].kernel_meta == ("w4a16", 256, 256, 128)
    ids = _ids(2, 9)
    pos = np.broadcast_to(np.arange(9), ids.shape)
    want, _ = jl.llama_forward(jp, jc, jnp.asarray(ids), jnp.asarray(pos),
                               use_kernels=False)
    got, _ = tl.llama_forward(tp, tc, torch.from_numpy(ids),
                              torch.from_numpy(np.array(pos)),
                              use_kernels=False)
    _close_logits(got, want)
    direct, _ = tl.llama_forward(params, config, torch.from_numpy(ids),
                                 torch.from_numpy(np.array(pos)),
                                 use_kernels=False)
    np.testing.assert_array_equal(got.numpy(), direct.numpy())


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """Without a card, an entry point not told to use the CPU raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = LlamaConfig(**SMALL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_synthetic_llama(config)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tl.init_kv_cache(config, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tl.load_llama_params(str(tmp_path))
    params = make_synthetic_llama(config, device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        greedy_generate(params, config, _ids(1, 4), max_new_tokens=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({"norm": np.ones(4, np.float32)})
