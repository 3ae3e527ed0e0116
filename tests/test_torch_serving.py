"""The port's ServingEngine against the JAX package's, in f32 on the CPU.

One tiny W4A16 group-128 checkpoint is loaded by both packages; the JAX
engine runs its non-kernel path (``use_kernels=False``), the port its
kernels' plain versions. The same requests go through both, and the
completions must be equal token for token, with the same finish reasons,
prefix-cache hits and preemptions: dense (flash decode at S_pad 512, the
block kernel below), paged, a one-token prefill chunk at the end of the
cache, an oversubscribed pool that preempts, a shared prompt prefix, decode
bursts and EOS. A tiny FP8_DYNAMIC checkpoint with k/v scales runs through
both engines with an fp8 KV cache, dense and paged."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compressed_tensors_tpu.engine import (
    Request as JRequest,
    ServingEngine as JEngine,
)
from compressed_tensors_tpu.models import llama as jl
from testing_utils import make_tiny_llama_checkpoint

from compressed_tensors_tpu_torch.engine import Request, ServingEngine
from compressed_tensors_tpu_torch.flags import flag_overrides
from compressed_tensors_tpu_torch.models import llama as tl
from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers

from torch_port_utils import (
    TORCH_TINY_CONFIG,
    fp8_dynamic_config,
    w4a16_config,
)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path, _ = make_tiny_llama_checkpoint(
        pathlib.Path(tmp_path_factory.mktemp("ckpt")),
        np.random.default_rng(0), w4a16_config(),
        model_config=TORCH_TINY_CONFIG)
    jp, jc, _ = jl.load_llama_params(path, dtype=jnp.float32,
                                     use_kernels=False)
    tp, tc, _ = tl.load_llama_params(path, dtype=torch.float32, device="cpu")
    return jp, jc, fuse_llama_layers(tp), tc


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=n).tolist() for n in lengths]


# (engine settings, prompt lengths, max_new_tokens)
SCENARIOS = {
    # S_pad 512: decode runs flash decode; 4 requests > 3 slots
    "dense-flash": (dict(max_batch=3, max_len=512, prefill_chunk=16),
                    (5, 20, 3, 9), 6),
    # S_pad 64: the block decode kernel, in bursts of 4 steps
    "dense-burst": (dict(max_batch=2, max_len=64, prefill_chunk=8,
                         steps_per_sync=4), (6, 3, 9), 7),
    "paged": (dict(max_batch=2, max_len=32, prefill_chunk=4, paged=True,
                   page_size=8, num_pages=2 * 4 + 2, steps_per_sync=3),
              (6, 3, 9, 5), 6),
    # a 17-token prompt near max_len ends in a one-token chunk, which
    # takes the decode kernels
    "dense-tail": (dict(max_batch=2, max_len=20, prefill_chunk=8),
                   (17, 10), 3),
    "paged-tail": (dict(max_batch=2, max_len=20, prefill_chunk=8,
                        paged=True, page_size=16), (17, 10), 3),
    # 4 usable pages < the 2 * 3 both sequences need: preemption
    "paged-preempt": (dict(max_batch=2, max_len=32, prefill_chunk=8,
                           paged=True, page_size=8, num_pages=5),
                      (10, 10), 12),
}


def _run_both(models, settings, batches, max_new, eos=None, cache=None):
    """Submit each batch of prompts, run to completion, next batch; returns
    both engines' completions keyed by request id, and the engines."""
    jp, jc, tp, tc = models
    j_eng = JEngine(jp, jc, dtype=jnp.float32, use_kernels=False,
                    cache_dtype=None if cache is None else jnp.dtype(cache),
                    **settings)
    t_eng = ServingEngine(tp, tc, dtype=torch.float32, device="cpu",
                          cache_dtype=None if cache is None
                          else getattr(torch, cache), **settings)
    got, want = {}, {}
    rid = 0
    for prompts in batches:
        for p in prompts:
            j_eng.submit(JRequest(request_id=rid, prompt_ids=p,
                                  max_new_tokens=max_new, eos_token_id=eos))
            t_eng.submit(Request(request_id=rid, prompt_ids=p,
                                 max_new_tokens=max_new, eos_token_id=eos))
            rid += 1
        want.update({c.request_id: (c.output_ids, c.finish_reason)
                     for c in j_eng.run()})
        got.update({c.request_id: (c.output_ids, c.finish_reason)
                    for c in t_eng.run()})
    return got, want, t_eng, j_eng


def _assert_same(got, want, t_eng, j_eng):
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid] == want[rid], rid
    assert t_eng.preemptions == j_eng.preemptions
    assert t_eng.prefix_cache_hits == getattr(j_eng, "prefix_cache_hits", 0)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_completions_match_jax(models, name):
    settings, lengths, max_new = SCENARIOS[name]
    got, want, t_eng, j_eng = _run_both(models, settings,
                                        [_prompts(len(name), lengths)],
                                        max_new)
    _assert_same(got, want, t_eng, j_eng)
    if name == "paged-preempt":
        assert t_eng.preemptions >= 1
    if t_eng.paged:  # every page back in the pool
        assert (len(t_eng._free_pages) + len(t_eng._cached_free)
                == t_eng.cache.k.shape[1] - 1)
        assert not t_eng._page_ref and not t_eng._tables.any()


def test_shared_prefix_reuses_pages_like_jax(models):
    """The second request reuses the first one's two full prompt pages."""
    shared = _prompts(7, (17,))[0]
    tails = _prompts(8, (3, 5))
    settings = dict(max_batch=2, max_len=64, prefill_chunk=8, paged=True,
                    page_size=8)
    got, want, t_eng, j_eng = _run_both(
        models, settings, [[shared + tails[0]], [shared + tails[1]]], 4)
    _assert_same(got, want, t_eng, j_eng)
    assert t_eng.prefix_cache_hits == 2


def test_eos_mid_burst_matches_jax(models):
    """EOS on the third generated token, inside a burst of 4: the tokens
    generated past it are truncated."""
    settings = dict(max_batch=2, max_len=64, prefill_chunk=8,
                    steps_per_sync=4)
    prompts = _prompts(9, (5, 11))
    free, _, _, _ = _run_both(models, settings, [prompts], 8)
    eos = free[0][0][2]
    got, want, t_eng, j_eng = _run_both(models, settings, [prompts], 8,
                                        eos=eos)
    _assert_same(got, want, t_eng, j_eng)
    assert got[0] == (free[0][0][:3], "stop")


@pytest.fixture(scope="module")
def fp8_models(tmp_path_factory):
    path, _ = make_tiny_llama_checkpoint(
        pathlib.Path(tmp_path_factory.mktemp("fp8")),
        np.random.default_rng(0), fp8_dynamic_config(),
        model_config=TORCH_TINY_CONFIG, kv_scales=True)
    jp, jc, _ = jl.load_llama_params(path, dtype=jnp.float32,
                                     use_kernels=False)
    tp, tc, _ = tl.load_llama_params(path, dtype=torch.float32, device="cpu")
    return jp, jc, fuse_llama_layers(tp), tc


@pytest.mark.parametrize("name", ["dense-flash", "paged"])
def test_fp8_kv_cache_completions_match_jax(fp8_models, name):
    """FP8 W8A8 weights, per-tensor k/v scales and an fp8 cache: flash
    decode over the dense cache (S_pad 512) and paged decode over the
    pool, through the scaled-cache kernels' plain versions."""
    settings, lengths, max_new = SCENARIOS[name]
    got, want, t_eng, j_eng = _run_both(
        fp8_models, settings, [_prompts(len(name) + 1, lengths)], max_new,
        cache="float8_e4m3fn")
    assert t_eng.cache.k.dtype == torch.float8_e4m3fn
    _assert_same(got, want, t_eng, j_eng)


def test_engine_defaults_to_cuda_and_names_unported_options(models,
                                                            monkeypatch):
    from compressed_tensors_tpu_torch.parallel import make_mesh

    _, _, tp, tc = models
    # a data-parallel mesh built without its groups: the engine starts,
    # and its first collective raises
    eng = ServingEngine(tp, tc, dtype=torch.float32, max_len=64,
                        mesh=make_mesh(dp=2, rank=0, world=2, device="cpu"))
    eng.submit(Request(request_id=0, prompt_ids=[1, 2, 3], max_new_tokens=2))
    with pytest.raises(RuntimeError, match="axis 'dp' .* no process group"):
        eng.run()
    # quantized KV caches are served: fp8 as it is, int8 under the transcode
    for paged in (False, True):
        eng = ServingEngine(tp, tc, dtype=torch.float32, max_len=64,
                            cache_dtype=torch.float8_e4m3fn, paged=paged,
                            device="cpu")
        assert eng.cache.k.dtype == torch.float8_e4m3fn
        with flag_overrides(fp8_transcode="always"):
            eng = ServingEngine(tp, tc, dtype=torch.float32, max_len=64,
                                cache_dtype=torch.float8_e4m3fn, paged=paged,
                                device="cpu")
        assert eng.cache.k.dtype == eng.cache.v.dtype == torch.int8
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(tp, tc)
