"""Attention of the PyTorch port against the JAX package, in f32 on the
CPU: the prefill and decode kernels' plain versions against the JAX
Pallas kernels in interpret mode (the model-level decode step with the JAX
head-packed cache is in test_torch_llama.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compressed_tensors_tpu.ops.kernels.decode_attention import (
    decode_attention as j_decode,
)
from compressed_tensors_tpu.ops.kernels.prefill_attention import (
    prefill_attention as j_prefill,
)

from compressed_tensors_tpu_torch.ops.kernels.decode_attention import (
    decode_attention,
)
from compressed_tensors_tpu_torch.ops.kernels.prefill_attention import (
    prefill_attention,
)

ATOL = 1e-5


@pytest.mark.parametrize("S", [40, 130])
def test_prefill_attention_matches_jax(S):
    rng = np.random.default_rng(S)
    B, H, KVH, D = 2, 8, 2, 32
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    want = np.asarray(j_prefill(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v)))
    got = prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(0)
    L, B, H, KVH, S_pad, D, Dp = 3, 4, 8, 2, 64, 32, 128
    layer = 1
    lengths = np.asarray([5, -1, 63, 0], np.int32)

    def lanes(a):  # zero-pad the head dim to the TPU's 128 lanes
        return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, Dp - D)])

    q = rng.standard_normal((B, H, D)).astype(np.float32)
    nk = rng.standard_normal((B, KVH, D)).astype(np.float32)
    nv = rng.standard_normal((B, KVH, D)).astype(np.float32)
    ck = rng.standard_normal((L, B, KVH, S_pad, D)).astype(np.float32)
    cv = rng.standard_normal((L, B, KVH, S_pad, D)).astype(np.float32)

    out_j, ck_j, cv_j = j_decode(
        jnp.asarray(lanes(q)), jnp.asarray(lanes(nk)), jnp.asarray(lanes(nv)),
        jnp.asarray(lanes(ck)), jnp.asarray(lanes(cv)), jnp.asarray(lengths),
        kvh=KVH, rep=H // KVH, d=Dp, true_d=D, layer=layer)
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    out_t, ck_t, cv_t = decode_attention(
        torch.from_numpy(q), torch.from_numpy(nk), torch.from_numpy(nv),
        tck, tcv, torch.from_numpy(lengths), layer=layer)
    assert ck_t is tck and cv_t is tcv  # updated in place

    active = lengths >= 0
    np.testing.assert_allclose(out_t.numpy()[active],
                               np.asarray(out_j)[active][..., :D],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tck.numpy(), np.asarray(ck_j)[..., :D],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tcv.numpy(), np.asarray(cv_j)[..., :D],
                               atol=ATOL, rtol=0)
    # the inactive row kept its bytes; active rows changed only at length
    np.testing.assert_array_equal(tck.numpy()[:, 1], ck[:, 1])
    changed = np.argwhere((tck.numpy() != ck).any(-1))
    assert sorted(map(tuple, changed[:, [0, 1, 3]])) == sorted(
        (layer, b, int(lengths[b])) for b in np.flatnonzero(active)
        for _ in range(KVH))
