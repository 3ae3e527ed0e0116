"""Attention of the PyTorch port against the JAX package, in f32 on the
CPU: the prefill and decode kernels' plain versions against the JAX
Pallas kernels in interpret mode (the model-level decode step with the JAX
head-packed cache is in test_torch_llama.py)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from compressed_tensors_tpu.ops.kernels.decode_attention import (
    decode_attention as j_decode,
)
from compressed_tensors_tpu.ops.kernels.flash_decode import (
    flash_decode_attention as j_flash,
)
from compressed_tensors_tpu.ops.kernels.paged_decode import (
    paged_decode_attention as j_paged,
)
from compressed_tensors_tpu.ops.kernels.prefill_attention import (
    prefill_attention as j_prefill,
)

from compressed_tensors_tpu_torch.ops.kernels.decode_attention import (
    SCORE_POSITIONS,
    block_decode_form,
    decode_attention,
)
from compressed_tensors_tpu_torch.ops.kernels.flash_decode import (
    CHUNK,
    SPLIT_TILES,
    attend_plain,
    flash_decode_attention,
    split_scratch,
)
from compressed_tensors_tpu_torch.ops.kernels.paged_decode import (
    paged_decode_attention,
)
from compressed_tensors_tpu_torch.ops.kernels.prefill_attention import (
    prefill_attention,
)

from torch_port_utils import raw_bytes, to_torch

ATOL = 1e-5


def _cache_values(rng, shape, cache):
    """Cache contents: f32 normals, int8 values, or fp8 e4m3 values of up
    to +-240 (numpy, ml_dtypes for fp8)."""
    if cache == "int8":
        return rng.integers(-128, 128, shape).astype(np.int8)
    if cache == "fp8":
        return rng.uniform(-240, 240, shape).astype(np.float32).astype(
            ml_dtypes.float8_e4m3fn)
    return rng.standard_normal(shape).astype(np.float32)


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


@pytest.mark.parametrize("scales", ["tensor", "head"])
@pytest.mark.parametrize("cache", ["fp8", "int8"])
def test_decode_attention_scaled_cache_matches_jax(cache, scales):
    """The block kernel on an fp8 or int8 cache with per-tensor or per-head
    k/v scales: the new row quantized in place bit for bit, the output of
    the folded arithmetic (k_scale on q, v_scale on the output)."""
    rng = np.random.default_rng(1)
    L, B, H, KVH, S_pad, D, Dp = 2, 4, 8, 2, 64, 32, 128
    layer = 1
    lengths = np.asarray([5, -1, 63, 0], np.int32)

    def lanes(a):  # zero-pad the head dim to the TPU's 128 lanes
        return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, Dp - D)])

    q = rng.standard_normal((B, H, D)).astype(np.float32)
    nk = rng.standard_normal((B, KVH, D)).astype(np.float32)
    nv = rng.standard_normal((B, KVH, D)).astype(np.float32)
    ck = _cache_values(rng, (L, B, KVH, S_pad, D), cache)
    cv = _cache_values(rng, (L, B, KVH, S_pad, D), cache)
    if scales == "tensor":
        ks, vs = (np.asarray([s], np.float32) for s in (0.02, 0.03))
    else:  # attn_head: (KVH, 1, 1)
        ks = np.asarray([0.02, 0.015], np.float32).reshape(KVH, 1, 1)
        vs = np.asarray([0.03, 0.01], np.float32).reshape(KVH, 1, 1)

    out_j, ck_j, cv_j = j_decode(
        jnp.asarray(lanes(q)), jnp.asarray(lanes(nk)), jnp.asarray(lanes(nv)),
        jnp.asarray(lanes(ck)), jnp.asarray(lanes(cv)), jnp.asarray(lengths),
        kvh=KVH, rep=H // KVH, d=Dp, true_d=D, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), layer=layer)
    tck, tcv = to_torch(ck.copy()), to_torch(cv.copy())
    out_t, _, _ = decode_attention(
        torch.from_numpy(q), torch.from_numpy(nk), torch.from_numpy(nv),
        tck, tcv, torch.from_numpy(lengths), layer=layer,
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))

    active = lengths >= 0
    np.testing.assert_allclose(out_t.numpy()[active],
                               np.asarray(out_j)[active][..., :D],
                               atol=ATOL * np.abs(out_t.numpy()).max(),
                               rtol=0)
    for got, want, before in ((tck, ck_j, ck), (tcv, cv_j, cv)):
        np.testing.assert_array_equal(raw_bytes(got),
                                      raw_bytes(want)[..., :D])
        changed = np.argwhere((raw_bytes(got) != raw_bytes(before)).any(-1))
        assert set(map(tuple, changed[:, [0, 1, 3]].tolist())) == {
            (layer, b, int(lengths[b])) for b in np.flatnonzero(active)}


# flash and paged decode: 2 layers, 4 rows (one inactive), 8 query / 2 KV
# heads of D = 128, 64-position chunks (the port's fixed chunk) or pages
FL, FB, FH, FKVH, FD, CH = 2, 4, 8, 2, 128, 64
F_LENGTHS = np.asarray([0, 70, -1, 127], np.int32)


def _decode_inputs(rng, cache_shape, cache):
    """q, new k/v and a cache (f32, or int8 / fp8 with per-tensor
    scales)."""
    q = rng.standard_normal((FB, FH, FD)).astype(np.float32)
    nk = rng.standard_normal((FB, FKVH, FD)).astype(np.float32)
    nv = rng.standard_normal((FB, FKVH, FD)).astype(np.float32)
    ck = _cache_values(rng, cache_shape, cache)
    cv = _cache_values(rng, cache_shape, cache)
    scales = ((np.asarray([0.02], np.float32), np.asarray([0.03], np.float32))
              if cache != "f32" else (None, None))
    return q, nk, nv, ck, cv, scales


def _jx(a):
    return None if a is None else jnp.asarray(a)


def _th(a):
    return None if a is None else to_torch(a.copy())


def _check_decode(out_t, cache_t, out_j, cache_j, original, rows_changed,
                  cache):
    active = F_LENGTHS >= 0
    # scaled caches give outputs of up to ~7: the same relative limit
    atol = ATOL if cache == "f32" else ATOL * np.abs(out_t.numpy()).max()
    np.testing.assert_allclose(out_t.numpy()[active], np.asarray(out_j)[active],
                               atol=atol, rtol=0)
    assert not out_t.numpy()[~active].any()  # inactive rows: zeros
    for got, want, before in zip(cache_t, cache_j, original):
        np.testing.assert_array_equal(raw_bytes(got), raw_bytes(want))
        changed = np.argwhere((raw_bytes(got) != raw_bytes(before)).any(-1))
        assert set(map(tuple, changed.tolist())) == set(rows_changed)


CACHES = ["f32", "int8", "fp8"]
CACHE_IDS = ["f32", "int8-scales", "fp8-scales"]


@pytest.mark.parametrize("cache", CACHES, ids=CACHE_IDS)
def test_flash_decode_matches_jax(cache):
    rng = np.random.default_rng(5)
    shape = (FL, FB, FKVH, 128, FD)
    q, nk, nv, ck, cv, (ks, vs) = _decode_inputs(rng, shape, cache)
    layer = 1
    out_j, ck_j, cv_j = j_flash(
        jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray(F_LENGTHS), kvh=FKVH, rep=FH // FKVH,
        d=FD, k_scale=_jx(ks), v_scale=_jx(vs), layer=layer, chunk=CH)
    tck, tcv = _th(ck), _th(cv)
    out_t, ck_t, cv_t = flash_decode_attention(
        torch.from_numpy(q), torch.from_numpy(nk), torch.from_numpy(nv), tck,
        tcv, torch.from_numpy(F_LENGTHS), layer=layer, k_scale=_th(ks),
        v_scale=_th(vs))
    assert ck_t is tck and cv_t is tcv  # updated in place
    written = [(layer, b, h, int(F_LENGTHS[b])) for b in range(FB)
               for h in range(FKVH) if F_LENGTHS[b] >= 0]
    _check_decode(out_t, (tck, tcv), out_j, (ck_j, cv_j), (ck, cv), written,
                  cache)


@pytest.mark.parametrize("cache", CACHES, ids=CACHE_IDS)
def test_paged_decode_matches_jax(cache):
    rng = np.random.default_rng(6)
    NP, P = 10, 2
    shape = (FL, NP, FKVH, CH, FD)
    q, nk, nv, pk, pv, (ks, vs) = _decode_inputs(rng, shape, cache)
    # shuffled pages; the inactive row points at the null page 0
    tables = rng.permutation(np.arange(1, NP))[:FB * P].reshape(FB, P)
    tables = tables.astype(np.int32)
    tables[2] = 0
    layer = 0
    out_j, pk_j, pv_j = j_paged(
        jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(tables), jnp.asarray(F_LENGTHS),
        kvh=FKVH, rep=FH // FKVH, d=FD, k_scale=_jx(ks), v_scale=_jx(vs),
        layer=layer)
    tpk, tpv = _th(pk), _th(pv)
    out_t, pk_t, pv_t = paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(nk), torch.from_numpy(nv), tpk,
        tpv, torch.from_numpy(tables), torch.from_numpy(F_LENGTHS),
        layer=layer, k_scale=_th(ks), v_scale=_th(vs))
    assert pk_t is tpk and pv_t is tpv
    written = [(layer, int(tables[b, F_LENGTHS[b] // CH]), h,
                int(F_LENGTHS[b] % CH)) for b in range(FB)
               for h in range(FKVH) if F_LENGTHS[b] >= 0]
    _check_decode(out_t, (tpk, tpv), out_j, (pk_j, pv_j), (pk, pv), written,
                  cache)
    assert np.array_equal(raw_bytes(tpk)[:, 0],
                          raw_bytes(pk)[:, 0])  # null page untouched


# the CUDA kernels' split order (``attend_plain(split=...)``): runs of 64
# and 128 positions, lengths on each side of a run boundary, an inactive row
SPLIT_LENGTHS = np.asarray([63, 64, -1, 65], np.int32)


def _split_out(q, nk, nv, keys, values, lengths, ks, vs, split):
    """attend_plain in the split order over (B, KVH, T, D) views, the new
    row quantized to the cache type first."""
    from compressed_tensors_tpu_torch.models.llama import _quantize_to_cache

    dtype = keys.dtype
    nk_c = _quantize_to_cache(torch.from_numpy(nk), ks, dtype, head_axis=1)
    nv_c = _quantize_to_cache(torch.from_numpy(nv), vs, dtype, head_axis=1)
    return attend_plain(torch.from_numpy(q), nk_c, nv_c, keys, values,
                        torch.from_numpy(lengths), ks, vs, split=split)


@pytest.mark.parametrize("split", [64, 128])
@pytest.mark.parametrize("cache", CACHES, ids=CACHE_IDS)
def test_flash_decode_split_order_matches_jax(cache, split):
    rng = np.random.default_rng(7)
    shape = (FL, FB, FKVH, 128, FD)
    q, nk, nv, ck, cv, (ks, vs) = _decode_inputs(rng, shape, cache)
    layer = 1
    out_j, _, _ = j_flash(
        jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray(SPLIT_LENGTHS), kvh=FKVH,
        rep=FH // FKVH, d=FD, k_scale=_jx(ks), v_scale=_jx(vs), layer=layer,
        chunk=CH)
    got = _split_out(q, nk, nv, _th(ck)[layer], _th(cv)[layer],
                     SPLIT_LENGTHS, _th(ks), _th(vs), split)
    active = SPLIT_LENGTHS >= 0
    atol = ATOL if cache == "f32" else ATOL * np.abs(got.numpy()).max()
    np.testing.assert_allclose(got.numpy()[active],
                               np.asarray(out_j)[active], atol=atol, rtol=0)
    assert not got.numpy()[~active].any()


@pytest.mark.parametrize("split", [64, 128])
@pytest.mark.parametrize("cache", CACHES, ids=CACHE_IDS)
def test_paged_decode_split_order_matches_jax(cache, split):
    rng = np.random.default_rng(8)
    NP, P = 10, 2
    q, nk, nv, pk, pv, (ks, vs) = _decode_inputs(rng, (FL, NP, FKVH, CH, FD),
                                                 cache)
    tables = rng.permutation(np.arange(1, NP))[:FB * P].reshape(FB, P)
    tables = tables.astype(np.int32)
    tables[2] = 0
    layer = 1
    out_j, _, _ = j_paged(
        jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(tables), jnp.asarray(SPLIT_LENGTHS),
        kvh=FKVH, rep=FH // FKVH, d=FD, k_scale=_jx(ks), v_scale=_jx(vs),
        layer=layer)

    def gather(pool):  # the rows' pages as (B, KVH, P * page, D)
        return _th(pool)[layer][torch.from_numpy(tables).long()].permute(
            0, 2, 1, 3, 4).reshape(FB, FKVH, P * CH, FD)

    got = _split_out(q, nk, nv, gather(pk), gather(pv), SPLIT_LENGTHS,
                     _th(ks), _th(vs), split)
    active = SPLIT_LENGTHS >= 0
    atol = ATOL if cache == "f32" else ATOL * np.abs(got.numpy()).max()
    np.testing.assert_allclose(got.numpy()[active],
                               np.asarray(out_j)[active], atol=atol, rtol=0)


@pytest.mark.parametrize("s_pad", [1, 64, 192, 511, 512, 513, 700, 2048])
def test_block_decode_form(s_pad):
    """The block decode kernel keeps the scores in shared memory up to
    SCORE_POSITIONS positions (every cache decode_attn="auto" sends it:
    S_pad < 512) and recomputes them in a second pass over K above."""
    form = block_decode_form(s_pad)
    assert form == ("scores" if s_pad <= SCORE_POSITIONS else "recompute")
    assert SCORE_POSITIONS >= 511


@pytest.mark.parametrize("itemsize", [2, 1])
def test_split_scratch_layout(itemsize):
    """The decode kernels' scratch: none when every row fits one split (the
    merge pass is not launched); else one f32 allocation, the unnormalized
    outputs first and the (max, sum) pairs after them."""
    B, KVH, rep, D = 3, 2, 4, 64
    span = SPLIT_TILES[itemsize] * CHUNK
    per, splits, ptrs = split_scratch(B, KVH, rep, D, span - 1, itemsize,
                                      "cpu")
    assert (per, splits, ptrs) == (SPLIT_TILES[itemsize], 1,
                                   (None, None, None))
    per, splits, (ml, o, keep) = split_scratch(B, KVH, rep, D, span, itemsize,
                                               "cpu")
    slots = B * KVH * splits * rep
    assert splits == 2 and keep.dtype == torch.float32
    assert keep.numel() == slots * (D + 2) and o == keep.data_ptr()
    assert ml == o + slots * D * 4 and ml % 8 == 0


@pytest.mark.parametrize("lengths", [(0, 1, 127, -1), (128, 200, 64, 129)])
@pytest.mark.parametrize("split", [16, 64, 128])
def test_split_order_equals_one_softmax(split, lengths):
    """Every split of the positions (lengths past the cache included: the
    new token follows all T cached positions) gives the one-softmax result
    up to f32 rounding."""
    rng = np.random.default_rng(split)
    B, H, KVH, T, D = 4, 8, 2, 128, 32

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, nk, nv = f32(B, H, D), f32(B, KVH, D), f32(B, KVH, D)
    keys, values = f32(B, KVH, T, D), f32(B, KVH, T, D)
    lens = torch.tensor(lengths, dtype=torch.int32)
    want = attend_plain(q, nk, nv, keys, values, lens, None, None)
    got = attend_plain(q, nk, nv, keys, values, lens, None, None, split=split)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
