"""quantized_matmul and projection fusion of the PyTorch port against the
JAX package, in f32 on the CPU: the port's kernel path (the W4A16 / W8A8
kernels' plain versions) and its non-kernel path against the JAX
``use_kernels=False`` output and the JAX Pallas kernel in interpret mode.
Tolerance: atol = rtol = 1e-4 * max|y|."""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from compressed_tensors_tpu.flags import flag_overrides as j_flags
from compressed_tensors_tpu.ops.fuse import fuse_quantized_tensors as j_fuse
from compressed_tensors_tpu.ops.kernels.w4a16_matmul import (
    w4a16_matmul as j_w4a16,
)
from compressed_tensors_tpu.ops.linear import (
    from_compressed_state as j_from_state,
    prepare_for_kernels as j_prepare,
    quantized_matmul as j_matmul,
)
from compressed_tensors_tpu.ops.pack import pack_to_int32 as j_pack
from compressed_tensors_tpu.quantization import (
    preset_name_to_scheme as j_preset,
)

from compressed_tensors_tpu_torch.flags import flag_overrides
from compressed_tensors_tpu_torch.ops.fuse import fuse_quantized_tensors
from compressed_tensors_tpu_torch.ops.kernels.w4a16_matmul import (
    _split_k,
    a8b_plan,
    choose_k_tile,
    int4b_design,
    int4b_plan,
    padded_k,
    w4a16_a8b_matmul,
)
from compressed_tensors_tpu_torch.ops.linear import (
    from_compressed_state,
    prepare_for_kernels,
    quantized_matmul,
)
from compressed_tensors_tpu_torch.quantization import preset_name_to_scheme

from torch_port_utils import to_torch


def _state(rng, preset, n, k, actorder=False):
    """A checkpoint-layout module state in numpy."""
    args = j_preset(preset, ["Linear"]).weights
    if preset in ("W8A8", "FP8_DYNAMIC"):
        w = (rng.integers(-128, 128, (n, k)).astype(np.int8)
             if preset == "W8A8" else
             rng.uniform(-400, 400, (n, k)).astype(ml_dtypes.float8_e4m3fn))
        return {"weight": w,
                "weight_scale": rng.uniform(1e-3, 1e-2, (n, 1)).astype(
                    np.float32)}
    g = args.group_size
    q = rng.integers(-8, 8, (n, k)).astype(np.int8)
    state = {
        "weight_packed": np.asarray(j_pack(jnp.asarray(q), 4)),
        "weight_scale": rng.uniform(1e-3, 1e-2, (n, k // g)).astype(
            np.float32),
        "weight_shape": np.asarray([n, k], np.int32),
    }
    if not args.symmetric:
        zp = rng.integers(-8, 8, (n, k // g)).astype(np.int8)
        state["weight_zero_point"] = np.asarray(
            j_pack(jnp.asarray(zp), 4, packed_dim=0))
    if actorder:
        state["weight_g_idx"] = rng.permutation(np.arange(k) // g).astype(
            np.int32)
    return state


def _both(state, preset, actorder=False):
    j_scheme = j_preset(preset, ["Linear"])
    t_scheme = preset_name_to_scheme(preset, ["Linear"])
    if actorder:
        j_scheme.weights.actorder = "group"
        t_scheme.weights.actorder = "group"
    jqt = j_from_state({k: jnp.asarray(v) for k, v in state.items()},
                       j_scheme)
    tqt = from_compressed_state({k: to_torch(v) for k, v in state.items()},
                                t_scheme)
    return jqt, tqt


def _close(got, want):
    got = got.detach().numpy()
    want = np.asarray(want, dtype=np.float32)
    tol = 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=1e-4)


CASES = [
    ("W4A16", 256, 512, False),
    ("W4A16_ASYM", 256, 512, False),
    ("W4A16", 128, 384, False),   # K not a multiple of the TPU k-tile
    ("W4A16", 128, 256, True),    # actorder (g_idx) checkpoint
    ("W8A8", 192, 256, False),
    ("FP8_DYNAMIC", 192, 256, False),
]


@pytest.mark.parametrize("preset,n,k,actorder", CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}{'-actorder' * c[3]}"
                              for c in CASES])
def test_quantized_matmul_matches_jax(preset, n, k, actorder):
    rng = np.random.default_rng(0)
    jqt, tqt = _both(_state(rng, preset, n, k, actorder), preset, actorder)
    x = rng.standard_normal((2, 5, k)).astype(np.float32)
    if preset in ("W8A8", "FP8_DYNAMIC"):
        # a row whose largest |x| is negative quantizes that element from
        # x/scale = -127.5, a rounding tie, and the JAX package's own two
        # paths break the tie differently; positive maxima avoid the tie
        i = np.abs(x).argmax(-1)[..., None]
        np.put_along_axis(x, i, np.abs(np.take_along_axis(x, i, -1)), -1)

    want = j_matmul(jnp.asarray(x), jqt, use_kernels=False)
    want_kernel = j_matmul(jnp.asarray(x), j_prepare(jqt), use_kernels=True)
    tx = torch.from_numpy(x)
    tk = prepare_for_kernels(tqt)
    assert tk.kernel_meta[0] == ("w4a16" if preset.startswith("W4")
                                 else "w8a8")
    got_kernel = quantized_matmul(tx, tk, use_kernels=True)
    got = quantized_matmul(tx, tqt, use_kernels=False)
    _close(got, want)
    _close(got_kernel, want)
    _close(got_kernel, want_kernel)


def test_int8_activation_mode_matches_jax():
    """w4_act="int8" selects the a8b mode: the port's plain version of it
    against the JAX kernel in interpret mode."""
    rng = np.random.default_rng(3)
    jqt, tqt = _both(_state(rng, "W4A16", 128, 256), "W4A16")
    x = rng.standard_normal((4, 256)).astype(np.float32)
    with j_flags(w4_act="int8"):
        want = j_matmul(jnp.asarray(x), j_prepare(jqt), use_kernels=True)
    with flag_overrides(w4_act="int8"):
        got = quantized_matmul(torch.from_numpy(x), prepare_for_kernels(tqt))
    _close(got, want)
    plain = quantized_matmul(torch.from_numpy(x), prepare_for_kernels(tqt))
    assert not torch.equal(got, plain)  # the mode changed the arithmetic


@pytest.mark.parametrize("preset", ["W4A16", "W4A16_ASYM"])
def test_a8b_matches_jax_kernel_and_dispatch(preset):
    """The a8b wrapper (its plain version on the CPU) against the JAX
    w4a16_matmul(mode="a8b") called directly on its own layout, and the
    port's dispatch under w4_act="int8" against the JAX dispatch."""
    rng = np.random.default_rng(4)
    n, k = 256, 512
    jqt, tqt = _both(_state(rng, preset, n, k), preset)
    jk, tk = j_prepare(jqt), prepare_for_kernels(tqt)
    x = rng.standard_normal((6, k)).astype(np.float32)
    _, jn, _, k_pad, g, j_tk = jk.kernel_meta
    want = j_w4a16(jnp.asarray(x), jk.kernel_packed, jk.kernel_scales,
                   jk.kernel_zp, n=jn, k=k_pad, group_size=g, tk=j_tk,
                   out_dtype=jnp.float32, mode="a8b")
    got = w4a16_a8b_matmul(torch.from_numpy(x), tk.kernel_packed,
                           tk.kernel_scales, tk.kernel_zp, n=n, k=k,
                           group_size=128)
    _close(got, want)
    with j_flags(w4_act="int8"):
        want = j_matmul(jnp.asarray(x), jk, use_kernels=True)
    with flag_overrides(w4_act="int8"):
        got = quantized_matmul(torch.from_numpy(x), tk)
    _close(got, want)


# (M, N, K): the 8B linears at the chunk sizes that select a8b, decode
# rows under w4_act="int8", ragged N and K (10.5 k-tiles)
A8B_PLAN_CASES = [(m, n, k) for m in (1, 64, 256, 300, 512, 1024)
                  for n, k in ((6144, 4096), (4096, 4096), (28672, 4096),
                               (4096, 14336), (200, 4096), (198, 1344))]


@pytest.mark.parametrize("m,n,k", A8B_PLAN_CASES)
def test_a8b_plan_covers_k(m, n, k):
    """a8b's K split: a cluster of 1-8 blocks, every block at least one
    128-deep k-tile and together all of them, no split cheaper by the
    plan's own estimate (waves of 128 x 128 blocks on 132 SMs times a
    block's k-tiles plus 4)."""
    tiles = -(-k // 128)
    splits, per = a8b_plan(m, n, k)
    assert 1 <= splits <= 8 and (splits - 1) * per < tiles <= splits * per
    blocks = -(-n // 128) * -(-m // 128)

    def cost(s):
        return -(-blocks * s // 132) * (-(-tiles // s) + 4)

    assert cost(-(-tiles // per)) <= min(cost(s) for s in (1, 2, 4, 8)
                                         if s <= tiles)


def test_a8b_plan_at_the_8b_chunk():
    """At a 512-row chunk of the 8B linears only qkv (192 tiles: 1.5 waves)
    splits K; at 256 rows the long down_proj (64 tiles) splits too."""
    shapes = {"qkv": (6144, 4096), "o": (4096, 4096),
              "gate_up": (28672, 4096), "down": (4096, 14336)}
    assert {name: a8b_plan(512, n, k)[0] for name, (n, k) in
            shapes.items()} == {"qkv": 2, "o": 1, "gate_up": 1, "down": 1}
    assert a8b_plan(256, 4096, 14336)[0] > 1


# (M, N, K): the fused linears of Llama-3-8B, TinyLlama-1.1B and
# Qwen2.5-7B at decode rows, the first prefill row count, a short serving
# chunk, a full one and a TinyLlama prefill of 64 x 128 tokens
INT4B_PLAN_CASES = [
    (m, n, k) for m in (1, 64, 65, 255, 512, 8192)
    for n, k in ((6144, 4096), (4096, 4096), (28672, 4096), (4096, 14336),
                 (2560, 2048), (2048, 2048), (11264, 2048), (2048, 5632),
                 (4608, 3584), (3584, 3584), (37888, 3584), (3584, 18944))]


@pytest.mark.parametrize("m,n,k", INT4B_PLAN_CASES)
def test_int4b_plan_covers_k(m, n, k):
    """int4b's plan: the decode design (16, 32 or 64 rows a block, the
    fewest that hold M; 128 weight rows) up to 64 rows, 128 x 192 tiles
    above; a cluster of 1-8 blocks along K, every block at least one
    64-deep k-tile and together all of them. Splits cut K at k-tile
    boundaries only; each split scales its own part of a group's sum, so
    neither design needs a group whole within one split."""
    tiles = k // 64
    bm, splits, per = int4b_plan(m, n, k)
    assert 1 <= splits <= 8 and (splits - 1) * per < tiles <= splits * per
    if int4b_design(m) == "decode":
        assert m <= bm == min(b for b in (16, 32, 64) if m <= b)
        # the column tiles of 128 times the split fill at most one wave of
        # blocks, two an SM
        assert splits == 1 or -(-n // 128) * splits <= 264
    else:
        assert m > 64 and bm == 128


def test_int4b_plan_at_the_model_shapes():
    """The plan at the 8B linears as the design sweep measured them: at 1
    and 64 rows gate_up's 224 column tiles fill the SMs (no split), qkv's
    48 split 4 ways, o_proj's and down_proj's 32 8 ways; 512-row chunks
    split only where the tiles leave SMs idle (o_proj, and the long K of
    down_proj); a TinyLlama prefill keeps one block a tile but for
    down_proj."""
    shapes = {"qkv": (6144, 4096), "o": (4096, 4096),
              "gate_up": (28672, 4096), "down": (4096, 14336)}

    def splits(m):
        return {name: int4b_plan(m, n, k)[1]
                for name, (n, k) in shapes.items()}

    for m in (1, 64):
        assert splits(m) == {"qkv": 4, "o": 8, "gate_up": 1, "down": 8}
    assert splits(512) == {"qkv": 1, "o": 4, "gate_up": 1, "down": 4}
    assert [int4b_plan(8192, n, k)[1] for n, k in
            ((2560, 2048), (2048, 2048), (11264, 2048), (2048, 5632))] == \
        [1, 1, 1, 2]


# (model, M, linear) -> B10's (splits, k-tiles a split) at the Qwen2.5-7B
# and Qwen3-8B W4A16 g128 shapes, as the plane-layout wrapper calls it
PLANES_SPLITS = {
    "qwen2.5": ({"qkv": (4608, 3584), "o": (3584, 3584),
                 "gate_up": (37888, 3584), "down": (3584, 18944)},
                {1: (2, 32, 4, 16, 1, 64, 4, 80),
                 64: (2, 32, 4, 16, 1, 64, 4, 80),
                 65: (2, 32, 4, 16, 1, 64, 4, 80),
                 512: (1, 64, 1, 64, 1, 64, 1, 304)}),
    "qwen3": ({"qkv": (6144, 4096), "o": (4096, 4096),
               "gate_up": (24576, 4096), "down": (4096, 12288)},
              {1: (2, 32, 4, 16, 1, 64, 4, 48),
               64: (2, 32, 4, 16, 1, 64, 4, 48),
               65: (2, 32, 4, 16, 1, 64, 4, 48),
               512: (1, 64, 1, 64, 1, 64, 1, 192)}),
}


@pytest.mark.parametrize("model", sorted(PLANES_SPLITS))
def test_planes_split_k_unchanged(model):
    """B10's K split (``_split_k``, which B1 no longer shares) keeps its
    values at the Qwen shapes."""
    shapes, want = PLANES_SPLITS[model]
    g = 128
    for m, flat in want.items():
        got = []
        for n, k in shapes.values():
            k_pad = padded_k(k, g)
            got += _split_k(m, n, k_pad, choose_k_tile(k, g) // 64,
                            tile_m=128 if m > 64 else 64, tile_n=128)
        assert tuple(got) == flat, (model, m)


def test_fused_projections_match_members():
    rng = np.random.default_rng(1)
    pairs = [_both(_state(rng, "W4A16", n, 256), "W4A16")
             for n in (128, 64, 64)]
    x = rng.standard_normal((3, 256)).astype(np.float32)
    j_fused = j_fuse([j for j, _ in pairs])
    t_fused = fuse_quantized_tensors([prepare_for_kernels(t) for _, t in pairs])
    assert t_fused.shape == (256, 256)
    assert t_fused.kernel_meta == ("w4a16", 256, 256, 128)
    got = quantized_matmul(torch.from_numpy(x), t_fused)
    _close(got, j_matmul(jnp.asarray(x), j_fused, use_kernels=False))
    parts = [quantized_matmul(torch.from_numpy(x), prepare_for_kernels(t))
             for _, t in pairs]
    np.testing.assert_array_equal(got.numpy(), torch.cat(parts, -1).numpy())


def test_mismatched_schemes_do_not_fuse():
    rng = np.random.default_rng(2)
    _, a = _both(_state(rng, "W4A16", 64, 256), "W4A16")
    _, b = _both(_state(rng, "W4A16_ASYM", 64, 256), "W4A16_ASYM")
    assert fuse_quantized_tensors([a, b]) is None
    c = dataclasses.replace(a, shape=(64, 128))
    assert fuse_quantized_tensors([a, c]) is None
