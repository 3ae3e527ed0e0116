"""The int32 8-plane W4A16 layout (``w4_layout="packed"``) and its modes
``int4``, ``a8`` and ``mat`` in the PyTorch port against the JAX package,
in f32 on the CPU.

- ``repack_w4_for_kernel`` and ``retile_groups`` equal the JAX functions
  bit for bit, and so does the whole prepared layout (words, scales, zero
  points, actorder permutation).
- The plain version of the plane kernel (``w4a16_planes_matmul`` on CPU
  tensors) within 1e-5 * max|y| of the JAX ``w4a16_matmul`` called
  directly in Pallas interpret mode (the JAX dispatch cannot reach these
  modes: it raises UnboundLocalError, ROADMAP C), in every mode,
  symmetric and asymmetric, with a K that needs padding and with
  actorder. Both compute the same f32 sums in another order.
- The port's dispatch reads ``w4_mode``; an unknown mode raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compressed_tensors_tpu.flags import flag_overrides as j_flags
from compressed_tensors_tpu.ops.kernels import w4a16_matmul as jw
from compressed_tensors_tpu.ops.linear import (
    from_compressed_state as j_from_state,
    prepare_for_kernels as j_prepare,
    quantized_matmul as j_matmul,
)
from compressed_tensors_tpu.ops.pack import pack_to_int32 as j_pack
from compressed_tensors_tpu.quantization import (
    QuantizationScheme as JScheme,
)

from compressed_tensors_tpu_torch.flags import flag_overrides
from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as tw
from compressed_tensors_tpu_torch.ops.linear import (
    from_compressed_state,
    prepare_for_kernels,
    quantized_matmul,
)
from compressed_tensors_tpu_torch.ops.pack import pack_to_int32
from compressed_tensors_tpu_torch.quantization import QuantizationScheme

from torch_port_utils import to_torch

# f32 on both sides, the same products summed in another order
TOL = 1e-5
MODES = ("int4", "a8", "mat")


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("n,k,g", [(64, 256, 32), (48, 320, 32),
                                   (16, 1024, 128), (8, 1536, 64)])
def test_repack_and_retile_bit_equal(n, k, g):
    rng = np.random.default_rng(k + g)
    assert (tw.choose_k_tile(k, g), tw.padded_k(k, g)) == (
        jw.choose_k_tile(k, g), jw.padded_k(k, g))
    tk, k_pad = tw.choose_k_tile(k, g), tw.padded_k(k, g)
    u = np.pad(rng.integers(0, 16, (n, k)), ((0, 0), (0, k_pad - k)),
               constant_values=8).astype(np.int32)
    want = np.asarray(jw.repack_w4_for_kernel(jnp.asarray(u), 4, k_pad, tk))
    got = tw.repack_w4_for_kernel(torch.from_numpy(u), 4, k_pad, tk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    s = rng.random((k_pad // g, n)).astype(np.float32)
    np.testing.assert_array_equal(
        tw.retile_groups(torch.from_numpy(s), k_pad, tk, g).numpy(),
        np.asarray(jw.retile_groups(jnp.asarray(s), k_pad, tk, g)))
    with pytest.raises(ValueError):
        tw.retile_groups(torch.from_numpy(s[1:]), k_pad, tk, g)


def _operands(rng, n, k, g, asym):
    """Plane-layout operands: words, (K_pad/g, N) scales with the padded
    groups at 0, zero points or None; K_pad the padded K."""
    k_pad, tk = tw.padded_k(k, g), tw.choose_k_tile(k, g)
    u = np.pad(rng.integers(0, 16, (n, k)), ((0, 0), (0, k_pad - k)),
               constant_values=8).astype(np.int32)
    words = np.array(jw.repack_w4_for_kernel(jnp.asarray(u), 4, k_pad, tk))
    scales = rng.uniform(1e-3, 2e-2, (k_pad // g, n)).astype(np.float32)
    scales[k // g:] = 0
    zp = (rng.integers(-8, 8, (k_pad // g, n)).astype(np.int8)
          if asym else None)
    return words, scales, zp, k_pad, tk


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_jax_kernel(mode, asym):
    rng = np.random.default_rng(MODES.index(mode) * 2 + asym)
    n, k, g = 64, 320, 32  # K padded to 512
    words, scales, zp, k_pad, tk = _operands(rng, n, k, g, asym)
    x = rng.standard_normal((5, k)).astype(np.float32)
    with j_flags(pallas_interpret=True):
        want = jw.w4a16_matmul(
            jnp.asarray(x), jnp.asarray(words), jnp.asarray(scales),
            None if zp is None else jnp.asarray(zp), n=n, k=k_pad,
            group_size=g, tk=tk, out_dtype=jnp.float32, mode=mode)
    got = tw.w4a16_planes_matmul(
        torch.from_numpy(x), torch.from_numpy(words),
        torch.from_numpy(scales),
        None if zp is None else torch.from_numpy(zp.astype(np.float32)),
        n=n, k=k_pad, group_size=g, mode=mode)
    assert got.shape == (5, n) and got.dtype == torch.float32
    _close(got, want)


def _state(rng, n, k, g, asym, actorder):
    """A pack-quantized W4A16 module state in numpy."""
    q = rng.integers(-8, 8, (n, k)).astype(np.int8)
    state = {"weight_packed": np.asarray(j_pack(jnp.asarray(q), 4)),
             "weight_scale": rng.uniform(1e-3, 1e-2, (n, k // g)).astype(
                 np.float32),
             "weight_shape": np.asarray([n, k], np.int32)}
    if asym:
        zp = rng.integers(-8, 8, (n, k // g)).astype(np.int8)
        state["weight_zero_point"] = np.asarray(
            j_pack(jnp.asarray(zp), 4, packed_dim=0))
    if actorder:
        state["weight_g_idx"] = rng.permutation(np.arange(k) // g).astype(
            np.int32)
    return state


def _both(state, g, asym, actorder):
    weights = {"num_bits": 4, "type": "int", "strategy": "group",
               "group_size": g, "symmetric": not asym}
    if actorder:
        weights["actorder"] = "group"
    jqt = j_from_state({k: jnp.asarray(v) for k, v in state.items()},
                       JScheme(targets=["Linear"], weights=weights))
    tqt = from_compressed_state(
        {k: to_torch(v) for k, v in state.items()},
        QuantizationScheme(targets=["Linear"], weights=weights))
    return jqt, tqt


PREPARE_CASES = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("asym,actorder", PREPARE_CASES,
                         ids=["sym", "asym", "sym-actorder", "asym-actorder"])
def test_packed_layout_and_modes_match_jax(asym, actorder):
    """The prepared plane layout equals the JAX one bit for bit, and the
    port's dispatch in each ``w4_mode`` equals the JAX kernel called
    directly on the JAX layout (x gathered by its actorder permutation)."""
    rng = np.random.default_rng(10 + 2 * asym + actorder)
    n, k, g = 40, 448, 32  # K padded to 512
    jqt, tqt = _both(_state(rng, n, k, g, asym, actorder), g, asym,
                     actorder)
    with j_flags(w4_layout="packed"):
        jk = j_prepare(jqt)
    with flag_overrides(w4_layout="packed"):
        tk = prepare_for_kernels(tqt)
    kind, _, _, k_pad, _, tile = jk.kernel_meta
    assert kind == "w4a16" and k_pad == 512
    assert tk.kernel_meta == ("w4packed", n, k, g)
    np.testing.assert_array_equal(tk.kernel_packed.numpy(),
                                  np.asarray(jk.kernel_packed))
    np.testing.assert_array_equal(tk.kernel_scales.numpy(),
                                  np.asarray(jk.kernel_scales))
    if asym:
        np.testing.assert_array_equal(tk.kernel_zp.numpy(),
                                      np.asarray(jk.kernel_zp, np.float32))
    else:
        assert tk.kernel_zp is None and jk.kernel_zp is None
    if actorder:
        np.testing.assert_array_equal(tk.kernel_perm.numpy(),
                                      np.asarray(jk.kernel_perm))

    x = rng.standard_normal((3, k)).astype(np.float32)
    xj = jnp.asarray(x)
    if actorder:
        xj = jnp.take(xj, jk.kernel_perm, axis=-1)
    for mode in MODES:
        with j_flags(pallas_interpret=True):
            want = jw.w4a16_matmul(
                xj, jk.kernel_packed, jk.kernel_scales, jk.kernel_zp, n=n,
                k=k_pad, group_size=g, tk=tile, out_dtype=jnp.float32,
                mode=mode)
        with flag_overrides(w4_mode=mode):
            _close(quantized_matmul(torch.from_numpy(x), tk), want)
    # int4 and mat against the non-kernel path of the JAX package (mat
    # rounds u * s in f32 here, so only f32 sums differ)
    ref = j_matmul(jnp.asarray(x), jqt, use_kernels=False)
    for mode in ("int4", "mat"):
        with flag_overrides(w4_mode=mode):
            _close(quantized_matmul(torch.from_numpy(x), tk), ref, 1e-4)


def test_unknown_w4_mode_raises():
    rng = np.random.default_rng(3)
    _, tqt = _both(_state(rng, 16, 256, 32, False, False), 32, False, False)
    with flag_overrides(w4_layout="packed"):
        tk = prepare_for_kernels(tqt)
    x = torch.from_numpy(rng.standard_normal((2, 256)).astype(np.float32))
    with flag_overrides(w4_mode="int8"), pytest.raises(ValueError,
                                                        match="w4_mode"):
        quantized_matmul(x, tk)
    with pytest.raises(ValueError, match="plane mode"):
        tw.w4a16_planes_matmul(x, tk.kernel_packed, tk.kernel_scales, None,
                               n=16, k=256, group_size=32, mode="int4b")


# ---- the offset form against the folded form (Qwen2.5 packed vs auto) ---- #

QWEN25_LINEARS = {"qkv_proj": (4608, 3584), "o_proj": (3584, 3584),
                  "gate_up_proj": (37888, 3584), "down_proj": (3584, 18944)}


def _offset_form(x, words, scales, zp, n, k, g):
    """Mode int4 in the TPU kernel's form (w4a16_matmul.py:401-437): per
    group x_j . u_j times s_j, minus the rank-8 correction sum(x_j) * (8 +
    zp_j) * s_j, in f32."""
    m = x.shape[0]
    xg = torch.nn.functional.pad(x, (0, k - x.shape[1])).reshape(m, k // g, g)
    u = tw._plane_codes(words, g).float().reshape(k // g, g, n)
    part = torch.einsum("mgr,grn->mgn", xg, u)
    return (part * scales).sum(dim=1) - xg.sum(dim=-1) @ ((8 + zp) * scales)


def c2_errors(rng, k, n=64, rows=4, shift=0.0, g=128):
    """One W4A16 g128 linear with zero points at real K (N cut to ``n``
    columns), x of ``rows`` bf16 rows N(shift, 1), in f32: max|y - y64| /
    max|y64| of B1's plain version (int4b), of B10's int4 in the offset
    form and of its plain version (the folded form), against the f64
    product with the dequantized weight."""
    q = rng.integers(-8, 8, (n, k))
    zp = rng.integers(-8, 8, (k // g, n)).astype(np.float32)
    s = torch.from_numpy(rng.uniform(1e-3, 3e-3, (k // g, n)).astype(
        np.float32)).to(torch.bfloat16).float()
    x = torch.from_numpy((rng.standard_normal((rows, k)) + shift).astype(
        np.float32)).to(torch.bfloat16).float()
    zt = torch.from_numpy(zp)
    w64 = ((torch.from_numpy(q).double()
            - zt.double().t().repeat_interleave(g, 1))
           * s.double().t().repeat_interleave(g, 1))
    y64 = x.double() @ w64.t()
    packed = pack_to_int32(torch.from_numpy(q.astype(np.int8)), 4)
    b1 = tw.w4a16_matmul_plain(x, packed, s, zt, n=n, k=k, group_size=g)
    k_pad, tk = tw.padded_k(k, g), tw.choose_k_tile(k, g)
    u = torch.nn.functional.pad(torch.from_numpy(q + 8), (0, k_pad - k),
                                value=8)
    words = tw.repack_w4_for_kernel(u, 4, k_pad, tk)
    pad = (0, 0, 0, k_pad // g - k // g)
    sp, zpp = (torch.nn.functional.pad(t, pad) for t in (s, zt))
    got = {"int4b": b1,
           "offset": _offset_form(x, words, sp, zpp, n, k_pad, g),
           "folded": tw.w4a16_planes_matmul(x, words, sp, zpp, n=n, k=k_pad,
                                            group_size=g, mode="int4")}
    top = y64.abs().max().item()
    return {name: (y.double() - y64).abs().max().item() / top
            for name, y in got.items()}


@pytest.mark.parametrize("k", [3584, 18944])
@pytest.mark.parametrize("shift", [0.0, 1.0], ids=["centred", "shifted"])
def test_folded_form_within_int4b_error_of_f64(k, shift):
    """At Qwen2.5-7B's K, in f32: the folded int4 plain version stands
    within 2x the int4b plain version's error of the f64 product (both sum
    exact small-integer products in f32). The TPU kernel's offset form
    subtracts sum(x) * (8 + zp) * s from sum(x * u) * s; with x shifted
    off zero those two terms are far larger than y, and it stands over 4x
    further off than int4b."""
    err = c2_errors(np.random.default_rng(int(k + 10 * shift)), k,
                    shift=shift)
    assert err["folded"] <= 2 * err["int4b"]
    if shift:
        assert err["offset"] > 4 * err["int4b"]


if __name__ == "__main__":
    # PYTHONPATH=.:tests python tests/test_torch_w4_planes.py: the trace, one Qwen2.5-7B
    # layer's fused linears (512 columns each, 4 rows)
    rng = np.random.default_rng(0)
    for shift in (0.0, 1.0):
        for lin, (n_full, k) in QWEN25_LINEARS.items():
            e = c2_errors(rng, k, n=512, shift=shift)
            print(f"x ~ N({shift:g}, 1) {lin} (N {n_full}, K {k}): "
                  + ", ".join(f"{name} {v:.3e}" for name, v in e.items()))
