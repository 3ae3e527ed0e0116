"""The port's CUDA kernels against their plain versions on the card, at
small shapes (``chip_smoke.py`` repeats this at the main path's shapes).
Marked ``cuda``: they skip without an NVIDIA GPU. On a machine with one:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda
"""

import itertools

import numpy as np
import pytest
import torch

from compressed_tensors_tpu_torch.ops.kernels import (
    decode_attention as da,
    flash_decode as fd,
    paged_decode as pd,
    prefill_attention as pa,
    w4a16_matmul as w4,
    w8a8_matmul as w8,
)

pytestmark = pytest.mark.cuda

# bf16 output rounding (2^-8 relative) plus another f32 summation order
TOL = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _bf16(rng, *shape, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        device, torch.bfloat16)


def _close(got, want):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL * want.float().abs().max().item()


@pytest.mark.parametrize("m,asym", [(5, False), (70, True)])
def test_w4a16_matmul(dev, m, asym):
    rng = np.random.default_rng(m)
    n, k, g = 192, 384, 128
    w = torch.from_numpy(rng.integers(-2**31, 2**31, (n, k // 8),
                                      dtype=np.int64).astype(np.int32)).to(dev)
    s = torch.from_numpy(rng.uniform(1e-3, 3e-3, (k // g, n)).astype(
        np.float32)).to(dev)
    zp = (torch.from_numpy(rng.integers(-8, 8, (k // g, n)).astype(
        np.float32)).to(dev) if asym else None)
    x = _bf16(rng, m, k, device=dev)
    before = w4.w4a16_matmul.launches
    got = w4.w4a16_matmul(x, w, s, zp, n=n, k=k, group_size=g)
    assert w4.w4a16_matmul.launches == before + 1
    _close(got, w4.w4a16_matmul_plain(x, w, s, zp, n=n, k=k, group_size=g))


# (M, N, K, group, zero points) of B1 (int4b): a small copy of
# chip_smoke.py's INT4B_GRID. N = 200 is one column tile of either design,
# so K of 1-13 k-tiles reaches every K split the plan can choose (1-8
# blocks of a cluster; 384 / 128 cuts every group) at decode rows (16, 32
# and 64 of them) and at 65 and 200 rows; then ragged N (odd: scalar
# stores, 4-byte scale copies), channel-wise groups, and more row tiles
# (rows fastest in the grid up to 512 rows, columns fastest above)
INT4B_CASES = [(1, 200, 64, 64, False), (7, 200, 128, 64, True),
               (33, 200, 192, 64, False), (64, 200, 256, 128, True),
               (16, 200, 320, 64, True), (17, 200, 384, 128, False),
               (64, 200, 448, 64, False), (5, 200, 512, 256, True),
               (9, 200, 576, 64, False), (40, 200, 704, 64, True),
               (65, 200, 64, 64, True), (65, 200, 192, 64, False),
               (65, 200, 320, 64, True), (65, 200, 512, 128, False),
               (65, 200, 576, 64, True), (200, 200, 704, 64, False),
               (3, 99, 128, 64, True), (100, 99, 256, 128, False),
               (64, 136, 1344, 1344, True), (300, 328, 1344, 1344, False),
               (700, 264, 512, 128, True), (130, 2048, 2048, 128, False)]


def test_int4b_cases_cover_designs_and_splits():
    """The cases reach the decode design at every K split its plan can
    choose (1-8 blocks of a cluster), the prefill design at 1, 2, 4 and 8,
    and a split that cuts a group in both (the plan is the wrapper's
    own)."""
    seen = set()
    for m, n, k, g, _ in INT4B_CASES:
        _, splits, per = w4.int4b_plan(m, n, k)
        design = w4.int4b_design(m)
        seen.add((design, splits))
        if splits > 1 and per * 64 % g:
            seen.add((design, "cut"))
    assert seen >= {(d, s) for d in ("decode", "prefill")
                    for s in range(1, 9)} | {("decode", "cut"),
                                             ("prefill", "cut")}


@pytest.mark.parametrize("m,n,k,g,asym", INT4B_CASES)
def test_int4b_grid(dev, m, n, k, g, asym):
    """B1 through the design and K split of ``int4b_plan``: every element
    within the a8b rule of the plain f32 result (exact integer weights,
    f32 sums: bf16 output rounding and f32 summation order), one launch."""
    gen = torch.Generator(device=dev).manual_seed(m * 7919 + n + k)
    w = torch.randint(-(2**31), 2**31, (n, k // 8), generator=gen, device=dev,
                      dtype=torch.int64).to(torch.int32)
    s = torch.rand((k // g, n), generator=gen, device=dev) * 2e-3 + 1e-3
    zp = (torch.randint(-8, 8, (k // g, n), generator=gen, device=dev).float()
          if asym else None)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    before = w4.w4a16_matmul.launches
    got = w4.w4a16_matmul(x, w, s, zp, n=n, k=k, group_size=g)
    assert w4.w4a16_matmul.launches == before + 1
    want = w4.w4a16_matmul_plain(x, w, s, zp, n=n, k=k, group_size=g,
                                 out_dtype=torch.float32)
    assert _within_a8b_rule(got, want)


@pytest.mark.parametrize("m,asym", [(5, False), (300, True)])
def test_w4a16_a8b_matmul(dev, m, asym):
    rng = np.random.default_rng(m)
    n, k, g = 192, 512, 128
    w = torch.from_numpy(rng.integers(-2**31, 2**31, (n, k // 8),
                                      dtype=np.int64).astype(np.int32)).to(dev)
    s = torch.from_numpy(rng.uniform(1e-3, 3e-3, (k // g, n)).astype(
        np.float32)).to(dev)
    zp = (torch.from_numpy(rng.integers(-8, 8, (k // g, n)).astype(
        np.float32)).to(dev) if asym else None)
    x = _bf16(rng, m, k, device=dev)
    xq = torch.empty((m, k), dtype=torch.int8, device=dev)
    xs = torch.empty((m,), dtype=torch.float32, device=dev)
    before = w4.w4a16_a8b_matmul.launches
    got = w4.w4a16_a8b_matmul(x, w, s, zp, n=n, k=k, group_size=g, xq=xq,
                              xs=xs)
    assert w4.w4a16_a8b_matmul.launches == before + 1
    # the quantization pass bit for bit
    xq_p, xs_p = w4.quantize_rows_a8b_plain(x)
    assert torch.equal(xq, xq_p) and torch.equal(xs, xs_p)
    # exact integer group sums: the output is the f32 plain result up to
    # bf16 rounding (2^-8 relative) and f32 summation order
    want = w4.w4a16_matmul_plain(x, w, s, zp, n=n, k=k, group_size=g,
                                 mode="a8b", out_dtype=torch.float32)
    err = (got.float() - want).abs()
    assert bool((err <= 2**-8 * want.abs() + 1e-4 * want.abs().max()).all())
    assert torch.equal(
        w4.w4a16_matmul(x, w, s, zp, n=n, k=k, group_size=g, mode="a8b"), got)


def _within_a8b_rule(got, want, flip=0.0):
    """Each element within 2^-8 * |y| (bf16 output rounding) plus 1e-4 *
    max|y| (f32 summation order) of the f32 plain result, plus ``flip``
    (the latent-head kernels' probability roundings: ``flip_rel``)."""
    err = (got.float() - want).abs()
    return bool((err <= 2**-8 * want.abs() + 1e-4 * want.abs().max()
                 + flip).all())


# (M, N, K, group) of the grouped-weight kernels: every row count the main
# paths give (1, 64: decode rows; 65, 127, 128, 300, 512: 128-row prefill
# tiles), N not a multiple of the 128-column tile (and odd), fp4 K a
# multiple of 32 but not of the 64-deep k-tile, groups 16, 32, 48 and 128,
# K split over a cluster at both designs, splits that cut a group
WNA16_CASES = [(5, 192, 384, 16), (5, 192, 384, 32), (7, 100, 96, 32),
               (300, 136, 256, 16), (1, 192, 384, 16), (64, 200, 96, 32),
               (33, 128, 256, 16), (3, 99, 128, 32), (65, 136, 256, 16),
               (70, 99, 128, 32), (127, 100, 352, 32), (128, 256, 512, 128),
               (512, 192, 384, 128), (5, 64, 1152, 128), (9, 64, 480, 48),
               (200, 64, 2048, 32)]


def test_wna16_cases_cover_designs_and_splits():
    """The cases reach both designs, a cluster split in each, and a split
    that cuts a group in each (the plan is the wrappers' own)."""
    seen = set()
    for m, n, k, g in WNA16_CASES:
        bm, splits, per = w4.wna16_plan(m, n, k)
        design = w4.wna16_design(m)
        seen.add(design)
        if splits > 1:
            seen.add((design, "split"))
            if per * 64 % g:
                seen.add((design, "cut"))
    assert seen >= {"decode", "prefill", ("decode", "split"),
                    ("prefill", "split"), ("decode", "cut"),
                    ("prefill", "cut")}


@pytest.mark.parametrize("m,n,k,g", WNA16_CASES)
def test_w4a16_fp4_matmul(dev, m, n, k, g):
    rng = np.random.default_rng(m + g)
    codes = torch.from_numpy(rng.integers(0, 256, (n, k // 2)).astype(
        np.uint8)).to(dev)
    # NVFP4-like e4m3 scales over a global scale, or E8M0 powers of two
    s = (rng.uniform(1e-3, 3e-3, (k // g, n)) if g == 16 else
         2.0 ** rng.integers(-9, -6, (k // g, n)))
    s = torch.from_numpy(s.astype(np.float32)).to(dev)
    x = _bf16(rng, m, k, device=dev)
    before = w4.w4a16_fp4_matmul.launches
    got = w4.w4a16_fp4_matmul(x, codes, s, n=n, k=k, group_size=g)
    assert w4.w4a16_fp4_matmul.launches == before + 1
    assert _within_a8b_rule(got, w4.w4a16_fp4_matmul_plain(
        x, codes, s, n=n, k=k, group_size=g, out_dtype=torch.float32))
    # no rows: nothing is launched and nothing counted
    assert w4.w4a16_fp4_matmul(x[:0], codes, s, n=n, k=k,
                               group_size=g).shape == (0, n)
    assert w4.w4a16_fp4_matmul.launches == before + 1


@pytest.mark.parametrize("m,n,k,g", WNA16_CASES + [(9, 64, 256, 128)])
def test_w4_e8_matmul(dev, m, n, k, g):
    rng = np.random.default_rng(m + g + 1)
    w8 = torch.from_numpy(rng.integers(-128, 128, (n, k)).astype(
        np.int8)).to(dev)
    s = torch.from_numpy(rng.uniform(1e-4, 3e-4, (k // g, n)).astype(
        np.float32)).to(dev)
    x = _bf16(rng, m, k, device=dev)
    before = w4.w4_e8_matmul.launches
    got = w4.w4_e8_matmul(x, w8, s, n=n, k=k, group_size=g)
    assert w4.w4_e8_matmul.launches == before + 1
    assert _within_a8b_rule(got, w4.w4_e8_matmul_plain(
        x, w8, s, n=n, k=k, group_size=g, out_dtype=torch.float32))
    assert w4.w4_e8_matmul(x[:0], w8, s, n=n, k=k,
                           group_size=g).shape == (0, n)
    assert w4.w4_e8_matmul.launches == before + 1
    with pytest.raises(NotImplementedError, match="multiple of 16"):
        w4.w4_e8_matmul(x[:, :24], w8[:, :24].contiguous(),
                        s[:1].contiguous(), n=n, k=24, group_size=24)
    # 32-bit offsets: a weight of 2^31 elements is refused before launch
    rows = 2**31 // k + 1
    with pytest.raises(NotImplementedError, match="32-bit offsets"):
        w4.w4_e8_matmul(x, w8[:1].expand(rows, k), s[:, :1].expand(k // g, rows),
                        n=rows, k=k, group_size=g)


def test_w8a8_matmul(dev):
    rng = np.random.default_rng(0)
    n, k = 200, 256
    x = _bf16(rng, 33, k, device=dev)
    w = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8)).to(dev)
    s = torch.from_numpy(rng.uniform(1e-4, 3e-4, n).astype(np.float32)).to(dev)
    _close(w8.w8a8_matmul(x, w, s, n=n, k=k),
           w8.w8a8_matmul_plain(x, w, s, n=n, k=k))


def test_prefill_attention(dev):
    rng = np.random.default_rng(0)
    q, k, v = (_bf16(rng, 2, 70, h, 64, device=dev) for h in (8, 2, 2))
    _close(pa.prefill_attention(q, k, v), pa.prefill_attention_plain(q, k, v))


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("rep", [1, 4, 7, 8])
@pytest.mark.parametrize("s", [65, 70, 128, 512, 1000])
def test_prefill_attention_shapes(dev, s, rep, d, b):
    """Ragged and whole tiles, GQA folds that do not divide a tile (rep 7),
    both head widths, one and several batch rows."""
    rng = np.random.default_rng(s * rep + d + b)
    kvh = 2
    q = _bf16(rng, b, s, kvh * rep, d, device=dev)
    k, v = (_bf16(rng, b, s, kvh, d, device=dev) for _ in range(2))
    before = pa.prefill_attention.launches
    got = pa.prefill_attention(q, k, v)
    assert pa.prefill_attention.launches == before + 1
    _close(got, pa.prefill_attention_plain(q, k, v))


def test_decode_attention_in_place(dev):
    rng = np.random.default_rng(0)
    q = _bf16(rng, 3, 8, 64, device=dev)
    nk, nv = _bf16(rng, 3, 2, 64, device=dev), _bf16(rng, 3, 2, 64, device=dev)
    ck, cv = _bf16(rng, 2, 3, 2, 64, 64, device=dev), _bf16(
        rng, 2, 3, 2, 64, 64, device=dev)
    lengths = torch.tensor([10, -1, 63], dtype=torch.int32, device=dev)
    ck_p, cv_p = ck.clone(), cv.clone()
    out, ck_r, cv_r = da.decode_attention(q, nk, nv, ck, cv, lengths, layer=1)
    assert ck_r is ck and cv_r is cv
    want, _, _ = da.decode_attention_plain(q, nk, nv, ck_p, cv_p, lengths,
                                           layer=1)
    _close(out[[0, 2]], want[[0, 2]])
    assert torch.equal(ck, ck_p) and torch.equal(cv, cv_p)


def _decode_operands(rng, dev, B=4, H=8, KVH=2, D=128):
    return (_bf16(rng, B, H, D, device=dev), _bf16(rng, B, KVH, D, device=dev),
            _bf16(rng, B, KVH, D, device=dev))


def test_flash_decode_in_place(dev):
    rng = np.random.default_rng(1)
    q, nk, nv = _decode_operands(rng, dev)
    ck, cv = (_bf16(rng, 2, 4, 2, 192, 128, device=dev) for _ in range(2))
    ck0, cv0 = ck.clone(), cv.clone()
    lengths = torch.tensor([0, -1, 100, 191], dtype=torch.int32, device=dev)
    ck_p, cv_p = ck.clone(), cv.clone()
    before = fd.flash_decode_attention.launches
    out, ck_r, cv_r = fd.flash_decode_attention(q, nk, nv, ck, cv, lengths,
                                                layer=1)
    assert fd.flash_decode_attention.launches == before + 1
    assert ck_r is ck and cv_r is cv
    want, _, _ = fd.flash_decode_attention_plain(q, nk, nv, ck_p, cv_p,
                                                 lengths, layer=1)
    _close(out[[0, 2, 3]], want[[0, 2, 3]])
    assert not out[1].any()  # inactive row: zeros
    assert torch.equal(ck, ck_p) and torch.equal(cv, cv_p)
    assert torch.equal(ck[:, 1], ck0[:, 1]) and torch.equal(cv[0], cv0[0])


def test_paged_decode_in_place_and_null_page(dev):
    rng = np.random.default_rng(2)
    q, nk, nv = _decode_operands(rng, dev)
    pk, pv = (_bf16(rng, 2, 9, 2, 64, 128, device=dev) for _ in range(2))
    pk0 = pk.clone()
    tables = torch.tensor([[3, 7], [0, 0], [5, 1], [8, 2]], dtype=torch.int32,
                          device=dev)
    lengths = torch.tensor([5, -1, 64, 127], dtype=torch.int32, device=dev)
    pk_p, pv_p = pk.clone(), pv.clone()
    out, pk_r, _ = pd.paged_decode_attention(q, nk, nv, pk, pv, tables,
                                             lengths, layer=0)
    assert pk_r is pk
    want, _, _ = pd.paged_decode_attention_plain(q, nk, nv, pk_p, pv_p,
                                                 tables, lengths, layer=0)
    _close(out[[0, 2, 3]], want[[0, 2, 3]])
    assert torch.equal(pk, pk_p) and torch.equal(pv, pv_p)
    assert torch.equal(pk[:, 0], pk0[:, 0])  # the null page is untouched
    # the paged and dense layouts of the same contents give the same bits
    dense_k = pk_p[0][tables.long()].permute(0, 2, 1, 3, 4).reshape(
        4, 2, 128, 128)
    dense_v = pv_p[0][tables.long()].permute(0, 2, 1, 3, 4).reshape(
        4, 2, 128, 128)
    pk2, pv2 = pk0.clone(), pv.clone()
    out_p, _, _ = pd.paged_decode_attention(q, nk, nv, pk2, pv2, tables,
                                            lengths, layer=0)
    lengths_d = lengths.clone()
    out_d, _, _ = fd.flash_decode_attention(
        q, nk, nv, dense_k[None].contiguous(), dense_v[None].contiguous(),
        lengths_d, layer=0)
    assert torch.equal(out_p[[0, 2, 3]], out_d[[0, 2, 3]])


def test_w8a8_fp8_matmul(dev):
    rng = np.random.default_rng(1)
    m, n, k = 33, 200, 256
    x = _bf16(rng, m, k, device=dev)
    w = torch.from_numpy(rng.uniform(-440, 440, (n, k)).astype(np.float32)).to(
        dev).to(torch.float8_e4m3fn)
    s = torch.from_numpy(rng.uniform(1e-4, 3e-4, n).astype(np.float32)).to(dev)
    xq = torch.empty((m, k), dtype=torch.float8_e4m3fn, device=dev)
    xs = torch.empty((m,), dtype=torch.float32, device=dev)
    before = w8.w8a8_matmul.fp8_launches
    got = w8.w8a8_matmul(x, w, s, n=n, k=k, xq=xq, xs=xs)
    assert w8.w8a8_matmul.fp8_launches == before + 1
    # the quantization pass bit for bit
    xq_p, xs_p = w8.quantize_rows_plain(x, w.dtype)
    assert torch.equal(xq.view(torch.uint8), xq_p.view(torch.uint8))
    assert torch.equal(xs, xs_p)
    # f32 sums of exact e4m3 products: the f32 plain result up to bf16
    # rounding (2^-8 relative) and f32 summation order
    want = w8.w8a8_matmul_plain(x, w, s, n=n, k=k, out_dtype=torch.float32)
    err = (got.float() - want).abs()
    assert bool((err <= 2**-8 * want.abs() + 1e-4 * want.abs().max()).all())


def _quantized_cache(rng, dtype, *shape, device):
    if dtype == torch.int8:
        return torch.from_numpy(rng.integers(-128, 128, shape).astype(
            np.int8)).to(device)
    return torch.from_numpy(rng.uniform(-240, 240, shape).astype(
        np.float32)).to(device).to(dtype)


def _same_bytes(a, b):
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.int8],
                         ids=["fp8", "int8"])
def test_scaled_cache_decode_kernels(dev, dtype):
    """Block (per-tensor and per-head scales), flash and paged decode on an
    fp8 or int8 cache: cache bytes equal to the plain version's, outputs
    within TOL, inactive rows and the null page untouched, dense and paged
    equal bit for bit."""
    rng = np.random.default_rng(3)
    q, nk, nv = _decode_operands(rng, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    per_tensor = (torch.tensor([0.02], **f32), torch.tensor([0.03], **f32))
    per_head = (torch.tensor([0.02, 0.015], **f32).reshape(2, 1, 1),
                torch.tensor([0.03, 0.01], **f32).reshape(2, 1, 1))
    lengths = torch.tensor([10, -1, 63, 0], dtype=torch.int32, device=dev)
    for ks, vs in (per_tensor, per_head):
        ck, cv = (_quantized_cache(rng, dtype, 2, 4, 2, 64, 128, device=dev)
                  for _ in range(2))
        ck_p, cv_p = ck.clone(), cv.clone()
        before = da.decode_attention.scaled_launches
        out, _, _ = da.decode_attention(q, nk, nv, ck, cv, lengths, layer=1,
                                        k_scale=ks, v_scale=vs)
        assert da.decode_attention.scaled_launches == before + 1
        want, _, _ = da.decode_attention_plain(q, nk, nv, ck_p, cv_p, lengths,
                                               layer=1, k_scale=ks, v_scale=vs)
        _close(out[[0, 2, 3]], want[[0, 2, 3]])
        assert _same_bytes(ck, ck_p) and _same_bytes(cv, cv_p)

    ks, vs = per_tensor
    lengths = torch.tensor([0, -1, 100, 191], dtype=torch.int32, device=dev)
    ck, cv = (_quantized_cache(rng, dtype, 2, 4, 2, 192, 128, device=dev)
              for _ in range(2))
    ck0, ck_p, cv_p = ck.clone(), ck.clone(), cv.clone()
    before = fd.flash_decode_attention.scaled_launches
    out, _, _ = fd.flash_decode_attention(q, nk, nv, ck, cv, lengths, layer=1,
                                          k_scale=ks, v_scale=vs)
    assert fd.flash_decode_attention.scaled_launches == before + 1
    want, _, _ = fd.flash_decode_attention_plain(
        q, nk, nv, ck_p, cv_p, lengths, layer=1, k_scale=ks, v_scale=vs)
    _close(out[[0, 2, 3]], want[[0, 2, 3]])
    assert not out[1].any()
    assert _same_bytes(ck, ck_p) and _same_bytes(cv, cv_p)
    assert _same_bytes(ck[:, 1], ck0[:, 1]) and _same_bytes(ck[0], ck0[0])

    pk, pv = (_quantized_cache(rng, dtype, 2, 9, 2, 64, 128, device=dev)
              for _ in range(2))
    pk0, pv0 = pk.clone(), pv.clone()
    tables = torch.tensor([[3, 7], [0, 0], [5, 1], [8, 2]], dtype=torch.int32,
                          device=dev)
    lengths = torch.tensor([5, -1, 64, 127], dtype=torch.int32, device=dev)
    pk_p, pv_p = pk.clone(), pv.clone()
    before = pd.paged_decode_attention.scaled_launches
    out_p, _, _ = pd.paged_decode_attention(q, nk, nv, pk, pv, tables, lengths,
                                            layer=0, k_scale=ks, v_scale=vs)
    assert pd.paged_decode_attention.scaled_launches == before + 1
    want, _, _ = pd.paged_decode_attention_plain(
        q, nk, nv, pk_p, pv_p, tables, lengths, layer=0, k_scale=ks,
        v_scale=vs)
    _close(out_p[[0, 2, 3]], want[[0, 2, 3]])
    assert _same_bytes(pk, pk_p) and _same_bytes(pv, pv_p)
    assert _same_bytes(pk[:, 0], pk0[:, 0])  # the null page is untouched
    # the same contents on the dense layout give the same bits
    dense_k, dense_v = (p[0].view(torch.uint8)[tables.long()].permute(
        0, 2, 1, 3, 4).reshape(4, 2, 128, 128).view(dtype)[None].contiguous()
        for p in (pk0, pv0))
    out_d, _, _ = fd.flash_decode_attention(q, nk, nv, dense_k, dense_v,
                                            lengths, layer=0, k_scale=ks,
                                            v_scale=vs)
    assert torch.equal(out_p[[0, 2, 3]], out_d[[0, 2, 3]])


# (M, N, K, group, zero points): padded K (448 -> 512) and K split over
# blocks at decode rows, ragged N, prefill rows with K split 4 ways
PLANE_CASES = [(5, 192, 448, 32, False), (70, 200, 1024, 128, True),
               (300, 64, 2048, 64, True)]


@pytest.mark.parametrize("mode", w4.PLANE_MODES)
@pytest.mark.parametrize("m,n,k,g,asym", PLANE_CASES)
def test_w4a16_planes_matmul(dev, mode, m, n, k, g, asym):
    rng = np.random.default_rng(m + g)
    k_pad, tk = w4.padded_k(k, g), w4.choose_k_tile(k, g)
    u = np.pad(rng.integers(0, 16, (n, k)), ((0, 0), (0, k_pad - k)),
               constant_values=8)
    words = w4.repack_w4_for_kernel(torch.from_numpy(u), 4, k_pad, tk).to(dev)
    s = rng.uniform(1e-3, 3e-3, (k_pad // g, n)).astype(np.float32)
    s[k // g:] = 0
    s = torch.from_numpy(s).to(dev)
    zp = (torch.from_numpy(rng.integers(-8, 8, (k_pad // g, n)).astype(
        np.float32)).to(dev) if asym else None)
    x = _bf16(rng, m, k, device=dev)
    counter = f"{mode}_launches"
    before = getattr(w4.w4a16_planes_matmul, counter)
    scratch = {}
    if mode == "a8":
        scratch = dict(xq=torch.empty((m, k), dtype=torch.int8, device=dev),
                       xs=torch.empty((m,), dtype=torch.float32, device=dev))
    got = w4.w4a16_planes_matmul(x, words, s, zp, n=n, k=k_pad, group_size=g,
                                 mode=mode, **scratch)
    assert getattr(w4.w4a16_planes_matmul, counter) == before + 1
    if mode == "a8":  # the quantization pass bit for bit
        xq_p, xs_p = w4.quantize_rows_a8b_plain(x)
        assert torch.equal(scratch["xq"], xq_p)
        assert torch.equal(scratch["xs"], xs_p)
    assert _within_a8b_rule(got, w4.w4a16_planes_matmul_plain(
        x, words, s, zp, n=n, k=k_pad, group_size=g, mode=mode,
        out_dtype=torch.float32))
    # no rows: nothing is launched and nothing counted
    assert w4.w4a16_planes_matmul(x[:0], words, s, zp, n=n, k=k_pad,
                                  group_size=g, mode=mode).shape == (0, n)
    assert getattr(w4.w4a16_planes_matmul, counter) == before + 1
    with pytest.raises(NotImplementedError, match="multiple of"):
        w4.w4a16_planes_matmul(x, words, s, zp, n=n, k=k_pad + 8,
                               group_size=g, mode=mode)


@pytest.mark.parametrize("mode", w4.PLANE_MODES)
@pytest.mark.parametrize("m", [1, 64, 100, 512])
@pytest.mark.parametrize("n,k,g,asym", [(200, 448, 32, False),
                                        (328, 1984, 128, True)])
def test_w4a16_planes_rows(dev, mode, m, n, k, g, asym):
    """The decode (64-row) and prefill (128-row) tiles at every row count
    the main paths give, N not a multiple of the 128-column tile, K_orig
    below K_pad, with and without zero points: the a8b rule."""
    rng = np.random.default_rng(m + n)
    k_pad, tk = w4.padded_k(k, g), w4.choose_k_tile(k, g)
    u = np.pad(rng.integers(0, 16, (n, k)), ((0, 0), (0, k_pad - k)),
               constant_values=8)
    words = w4.repack_w4_for_kernel(torch.from_numpy(u), 4, k_pad, tk).to(dev)
    s = rng.uniform(1e-3, 3e-3, (k_pad // g, n)).astype(np.float32)
    s[-(-k // g):] = 0
    s = torch.from_numpy(s).to(dev)
    zp = (torch.from_numpy(rng.integers(-8, 8, (k_pad // g, n)).astype(
        np.float32)).to(dev) if asym else None)
    x = _bf16(rng, m, k, device=dev)
    got = w4.w4a16_planes_matmul(x, words, s, zp, n=n, k=k_pad, group_size=g,
                                 mode=mode)
    assert _within_a8b_rule(got, w4.w4a16_planes_matmul_plain(
        x, words, s, zp, n=n, k=k_pad, group_size=g, mode=mode,
        out_dtype=torch.float32))


def test_attention_kernels_at_seven_heads_per_kv_head(dev):
    """Qwen2.5-7B's GQA ratio (H = 28, KVH = 4, D = 128): prefill, block,
    flash and paged decode against their plain versions."""
    rng = np.random.default_rng(7)
    H, KVH, D = 28, 4, 128
    q, k, v = (_bf16(rng, 2, 70, h, D, device=dev) for h in (H, KVH, KVH))
    _close(pa.prefill_attention(q, k, v), pa.prefill_attention_plain(q, k, v))

    q, nk, nv = _decode_operands(rng, dev, H=H, KVH=KVH)
    lengths = torch.tensor([0, -1, 100, 191], dtype=torch.int32, device=dev)
    live = [0, 2, 3]
    for kernel, plain in ((da.decode_attention, da.decode_attention_plain),
                          (fd.flash_decode_attention,
                           fd.flash_decode_attention_plain)):
        ck, cv = (_bf16(rng, 2, 4, KVH, 192, D, device=dev) for _ in range(2))
        ck_p, cv_p = ck.clone(), cv.clone()
        out, _, _ = kernel(q, nk, nv, ck, cv, lengths, layer=1)
        want, _, _ = plain(q, nk, nv, ck_p, cv_p, lengths, layer=1)
        _close(out[live], want[live])
        assert torch.equal(ck, ck_p) and torch.equal(cv, cv_p)

    pk, pv = (_bf16(rng, 2, 9, KVH, 64, D, device=dev) for _ in range(2))
    tables = torch.tensor([[3, 7, 4], [0, 0, 0], [5, 1, 6], [8, 2, 0]],
                          dtype=torch.int32, device=dev)
    lengths = torch.tensor([5, -1, 130, 127], dtype=torch.int32, device=dev)
    pk_p, pv_p = pk.clone(), pv.clone()
    out, _, _ = pd.paged_decode_attention(q, nk, nv, pk, pv, tables, lengths,
                                          layer=1)
    want, _, _ = pd.paged_decode_attention_plain(q, nk, nv, pk_p, pv_p,
                                                 tables, lengths, layer=1)
    _close(out[live], want[live])
    assert torch.equal(pk, pk_p) and torch.equal(pv, pv_p)


# B3 (int8 and fp8): every row count the main paths give (decode rows
# 1-64, 128-row prefill tiles above), N not a multiple of the 128-column
# tile, K from one 64-deep tail to 14336, 1280 (10 k-tiles) cut unevenly by a
# cluster split
W8A8_M = [1, 16, 63, 64, 65, 128, 300, 512]
W8A8_NK = [(200, 64), (328, 1280), (136, 14336)]


def test_w8a8_cases_cover_designs_and_splits():
    """The cases reach both designs, a cluster split at decode rows, and a
    split that leaves its last block fewer k-tiles (the plan is the
    wrapper's own)."""
    seen = set()
    for m, (n, k) in itertools.product(W8A8_M, W8A8_NK):
        bm, splits, per = w8.w8a8_plan(m, n, k)
        design = "decode" if bm <= 64 else "prefill"
        seen.add(design)
        if splits > 1:
            seen.add((design, "split"))
            if splits * per != -(-k // 128):
                seen.add((design, "uneven"))
    assert seen >= {"decode", "prefill", ("decode", "split"),
                    ("decode", "uneven")}


def _misaligned_w8a8_operands(device):
    """x as a contiguous (4, 64) view 2 bytes into its storage, and the
    other operands as the kernel wants them."""
    n, k = 32, 64
    x = torch.zeros(4 * k + 1, dtype=torch.bfloat16, device=device)[1:]
    x = x.view(4, k)
    w = torch.zeros((n, k), dtype=torch.int8, device=device)
    s = torch.ones(n, dtype=torch.float32, device=device)
    return x, w, s, n, k


def test_w8a8_operand_check_refuses_misaligned_views():
    """The kernels move x, W, the scale and xq 16 bytes a copy: a view at
    an odd offset is refused before launch (runs on the CPU)."""
    x, w, s, n, k = _misaligned_w8a8_operands("cpu")
    assert x.is_contiguous() and x.data_ptr() % 16
    xq = torch.empty((4, k), dtype=torch.int8)
    xs = torch.empty(4, dtype=torch.float32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        w8.check_w8a8_operands(x, w, s, xq, xs, n=n, k=k)
    w8.check_w8a8_operands(x.clone(), w, s, xq, xs, n=n, k=k)
    with pytest.raises(ValueError, match="16-byte aligned"):
        w8.check_w8a8_operands(x.clone(), w, s,
                               torch.empty(4 * k + 1, dtype=torch.int8)[1:]
                               .view(4, k), xs, n=n, k=k)


def test_w8a8_matmul_refuses_misaligned_views(dev):
    x, w, s, n, k = _misaligned_w8a8_operands(dev)
    before = w8.w8a8_matmul.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        w8.w8a8_matmul(x, w, s, n=n, k=k)
    assert w8.w8a8_matmul.launches == before


@pytest.mark.parametrize("weight", ["int8", "fp8"])
@pytest.mark.parametrize("n,k", W8A8_NK)
@pytest.mark.parametrize("m", W8A8_M)
def test_w8a8_matmul_shapes(dev, m, n, k, weight):
    rng = np.random.default_rng(m + k)
    x = _bf16(rng, m, k, device=dev)
    if weight == "int8":
        w = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(
            np.int8)).to(dev)
    else:
        w = torch.from_numpy(np.clip(rng.standard_normal((n, k)) * 100, -440,
                                     440).astype(np.float32)).to(dev).to(
            torch.float8_e4m3fn)
    s = torch.from_numpy(rng.uniform(1e-4, 3e-4, n).astype(np.float32)).to(dev)
    xq = torch.empty((m, k), dtype=w.dtype, device=dev)
    xs = torch.empty((m,), dtype=torch.float32, device=dev)
    counter = "fp8_launches" if weight == "fp8" else "launches"
    before = getattr(w8.w8a8_matmul, counter)
    got = w8.w8a8_matmul(x, w, s, n=n, k=k, xq=xq, xs=xs)
    assert getattr(w8.w8a8_matmul, counter) == before + 1
    xq_p, xs_p = w8.quantize_rows_plain(x, w.dtype)
    assert torch.equal(xq.view(torch.uint8), xq_p.view(torch.uint8))
    assert torch.equal(xs, xs_p)
    assert _within_a8b_rule(got, w8.w8a8_matmul_plain(
        x, w, s, n=n, k=k, out_dtype=torch.float32))


# B6/B7 on every cache type: lengths 0, 1, 63-65, each side of a split
# boundary and S_pad - 1, an inactive row; GQA folds 1-16, both head widths
def _split_span(dtype):
    return fd.SPLIT_TILES[torch.empty(0, dtype=dtype).element_size()] * 64


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.float8_e4m3fn,
                                   torch.int8], ids=["bf16", "fp8", "int8"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("rep", [1, 4, 7, 8, 16])
def test_flash_and_paged_decode_grid(dev, rep, d, cache):
    from compressed_tensors_tpu_torch.models.llama import _quantize_to_cache

    rng = np.random.default_rng(rep * d)
    kvh, page = 2, 64
    span = _split_span(cache)
    s_pad = span + 192
    lens = [0, 1, 63, 64, 65, span - 1, span, span + 1, s_pad - 1, -1]
    B, P = len(lens), s_pad // page
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    live = [b for b in range(B) if lens[b] >= 0]
    q, nk, nv = _decode_operands(rng, dev, B=B, H=kvh * rep, KVH=kvh, D=d)
    scaled = cache != torch.bfloat16
    f32 = dict(dtype=torch.float32, device=dev)
    ks = torch.tensor([0.02], **f32) if scaled else None
    vs = torch.tensor([0.03], **f32) if scaled else None

    def make(*shape):
        if scaled:
            return _quantized_cache(rng, cache, *shape, device=dev)
        return _bf16(rng, *shape, device=dev)

    nk_c = _quantize_to_cache(nk, ks, cache, head_axis=1)
    nv_c = _quantize_to_cache(nv, vs, cache, head_axis=1)
    counter = "scaled_launches" if scaled else "launches"

    # the slab
    ck, cv = make(2, B, kvh, s_pad, d), make(2, B, kvh, s_pad, d)
    ck0, cv0 = ck.clone(), cv.clone()
    before = getattr(fd.flash_decode_attention, counter)
    out, _, _ = fd.flash_decode_attention(q, nk, nv, ck, cv, lengths,
                                          layer=1, k_scale=ks, v_scale=vs)
    assert getattr(fd.flash_decode_attention, counter) == before + 1
    ck_p, cv_p = ck0.clone(), cv0.clone()
    want, _, _ = fd.flash_decode_attention_plain(
        q, nk, nv, ck_p, cv_p, lengths, layer=1, k_scale=ks, v_scale=vs)
    split = fd.attend_plain(q, nk_c, nv_c, ck0[1], cv0[1], lengths, ks, vs,
                            split=span)
    _close(out[live], want[live])
    _close(out[live], split[live])
    assert not out[B - 1].any()
    assert _same_bytes(ck, ck_p) and _same_bytes(cv, cv_p)
    changed = torch.nonzero((ck.view(torch.uint8) != ck0.view(torch.uint8))
                            .any(-1)).tolist()
    assert sorted(map(tuple, changed)) == sorted(
        (1, b, h, lens[b]) for b in live for h in range(kvh))

    # the pool through shuffled page tables (the inactive row on page 0)
    tables = rng.permutation(np.arange(1, B * P + 1)).astype(np.int32)
    tables = tables.reshape(B, P)
    tables[B - 1] = 0
    tables_d = torch.from_numpy(tables).to(dev)
    pk, pv = make(2, B * P + 1, kvh, page, d), make(2, B * P + 1, kvh, page, d)
    pk0 = pk.clone()
    pk_p, pv_p = pk.clone(), pv.clone()
    before = getattr(pd.paged_decode_attention, counter)
    out_p, _, _ = pd.paged_decode_attention(q, nk, nv, pk, pv, tables_d,
                                            lengths, layer=1, k_scale=ks,
                                            v_scale=vs)
    assert getattr(pd.paged_decode_attention, counter) == before + 1
    want, _, _ = pd.paged_decode_attention_plain(
        q, nk, nv, pk_p, pv_p, tables_d, lengths, layer=1, k_scale=ks,
        v_scale=vs)
    _close(out_p[live], want[live])
    assert not out_p[B - 1].any()
    assert _same_bytes(pk, pk_p) and _same_bytes(pv, pv_p)
    changed = torch.nonzero((pk.view(torch.uint8) != pk0.view(torch.uint8))
                            .any(-1)).tolist()
    assert sorted(map(tuple, changed)) == sorted(
        (1, int(tables[b, lens[b] // page]), h, lens[b] % page)
        for b in live for h in range(kvh))


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.float8_e4m3fn],
                         ids=["bf16", "fp8"])
@pytest.mark.parametrize("page", [16, 32])
def test_paged_decode_pages_smaller_than_a_tile(dev, page, cache):
    """Pool pages of 16 and 32 positions: a 64-position tile spans several
    pages, each row found through its own table entry; dense and paged
    layouts of the same contents give the same bits."""
    rng = np.random.default_rng(page)
    B, kvh, rep, d = 4, 2, 4, 128
    span = _split_span(cache)
    s_pad = span + 128
    P = s_pad // page
    lens = [5, span + 3, -1, s_pad - 1]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    live = [0, 1, 3]
    q, nk, nv = _decode_operands(rng, dev, B=B, H=kvh * rep, KVH=kvh, D=d)
    scaled = cache != torch.bfloat16
    f32 = dict(dtype=torch.float32, device=dev)
    ks = torch.tensor([0.02], **f32) if scaled else None
    vs = torch.tensor([0.03], **f32) if scaled else None

    def make(*shape):
        if scaled:
            return _quantized_cache(rng, cache, *shape, device=dev)
        return _bf16(rng, *shape, device=dev)

    tables = rng.permutation(np.arange(1, B * P + 1)).astype(np.int32)
    tables = tables.reshape(B, P)
    tables[2] = 0
    tables_d = torch.from_numpy(tables).to(dev)
    pk, pv = make(1, B * P + 1, kvh, page, d), make(1, B * P + 1, kvh, page, d)
    pk0, pv0 = pk.clone(), pv.clone()
    pk_p, pv_p = pk.clone(), pv.clone()
    out, _, _ = pd.paged_decode_attention(q, nk, nv, pk, pv, tables_d, lengths,
                                          k_scale=ks, v_scale=vs)
    want, _, _ = pd.paged_decode_attention_plain(
        q, nk, nv, pk_p, pv_p, tables_d, lengths, k_scale=ks, v_scale=vs)
    _close(out[live], want[live])
    assert not out[2].any()
    assert _same_bytes(pk, pk_p) and _same_bytes(pv, pv_p)
    dense_k, dense_v = (p[0].view(torch.uint8)[tables_d.long()].permute(
        0, 2, 1, 3, 4).reshape(B, kvh, s_pad, -1).view(cache)[None]
        .contiguous() for p in (pk0, pv0))
    out_d, _, _ = fd.flash_decode_attention(q, nk, nv, dense_k, dense_v,
                                            lengths, k_scale=ks, v_scale=vs)
    assert torch.equal(out[live], out_d[live])


# B2 (a8b): decode rows, ragged chunks, N not a multiple of the 128-column
# tile (198 not of 4 either), groups 64 and 128 and channel-wise (1344: an
# odd multiple of 64, 10.5 k-tiles cut unevenly by a cluster split), with
# and without zero points
A8B_CASES = [(m, n, k, g, asym) for m in (1, 64, 65, 256, 300)
             for n, k, g, asym in ((200, 1024, 64, False),
                                   (328, 2048, 128, True),
                                   (198, 1344, 1344, True),
                                   (136, 1344, 1344, False))]


@pytest.mark.parametrize("m,n,k,g,asym", A8B_CASES)
def test_a8b_grid(dev, m, n, k, g, asym):
    rng = np.random.default_rng(m + n)
    w = torch.from_numpy(rng.integers(-2**31, 2**31, (n, k // 8),
                                      dtype=np.int64).astype(np.int32)).to(dev)
    s = torch.from_numpy(rng.uniform(1e-3, 3e-3, (k // g, n)).astype(
        np.float32)).to(dev)
    zp = (torch.from_numpy(rng.integers(-8, 8, (k // g, n)).astype(
        np.float32)).to(dev) if asym else None)
    x = _bf16(rng, m, k, device=dev)
    xq = torch.empty((m, k), dtype=torch.int8, device=dev)
    xs = torch.empty((m,), dtype=torch.float32, device=dev)
    kw = dict(n=n, k=k, group_size=g)
    got = w4.w4a16_a8b_matmul(x, w, s, zp, xq=xq, xs=xs, **kw)
    xq_p, xs_p = w4.quantize_rows_a8b_plain(x)
    assert torch.equal(xq, xq_p) and torch.equal(xs, xs_p)
    want = w4.w4a16_matmul_plain(x, w, s, zp, mode="a8b",
                                 out_dtype=torch.float32, **kw)
    assert _within_a8b_rule(got, want)
    # the int4b control (no int8 rounding of x) falls outside the rule
    assert not _within_a8b_rule(
        w4.w4a16_matmul(x, w, s, zp, mode="int4b", **kw), want)


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.float8_e4m3fn,
                                   torch.int8], ids=["bf16", "fp8", "int8"])
@pytest.mark.parametrize("s_pad", [64, 192, 511, 700])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("rep", [1, 4, 7, 16])
def test_block_decode_grid(dev, rep, d, s_pad, cache):
    """B5 in both forms (S_pad 700: "recompute"), per-tensor and per-head
    scales: outputs within TOL, inactive rows zero, cache bytes equal to
    the plain version's and written at lengths[b] only."""
    rng = np.random.default_rng(rep * d + s_pad)
    kvh = 2
    lens = [0, 1, 63, 64, 65, s_pad - 1, -1]
    B = len(lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    live = [b for b in range(B) if lens[b] >= 0]
    q, nk, nv = _decode_operands(rng, dev, B=B, H=kvh * rep, KVH=kvh, D=d)
    scaled = cache != torch.bfloat16
    f32 = dict(dtype=torch.float32, device=dev)
    scales = [(None, None)] if not scaled else [
        (torch.tensor([0.02], **f32), torch.tensor([0.03], **f32)),
        (torch.tensor([0.02, 0.015], **f32).reshape(2, 1, 1),
         torch.tensor([0.03, 0.01], **f32).reshape(2, 1, 1))]
    counter = "scaled_launches" if scaled else "launches"
    for ks, vs in scales:
        shape = (2, B, kvh, s_pad, d)
        ck, cv = ((_quantized_cache(rng, cache, *shape, device=dev) if scaled
                   else _bf16(rng, *shape, device=dev)) for _ in range(2))
        ck0 = ck.clone()
        ck_p, cv_p = ck.clone(), cv.clone()
        before = getattr(da.decode_attention, counter)
        out, _, _ = da.decode_attention(q, nk, nv, ck, cv, lengths, layer=1,
                                        k_scale=ks, v_scale=vs)
        assert getattr(da.decode_attention, counter) == before + 1
        want, _, _ = da.decode_attention_plain(
            q, nk, nv, ck_p, cv_p, lengths, layer=1, k_scale=ks, v_scale=vs)
        _close(out[live], want[live])
        assert not out[B - 1].any()
        assert _same_bytes(ck, ck_p) and _same_bytes(cv, cv_p)
        changed = torch.nonzero((ck.view(torch.uint8) != ck0.view(torch.uint8))
                                .any(-1)).tolist()
        assert sorted(map(tuple, changed)) == sorted(
            (1, b, h, lens[b]) for b in live for h in range(kvh)
            if lens[b] < s_pad)


# ---- the expert-batched launches of the MoE layer (B1e, B2e, B9e) ------ #

# (E, C, N, K, group, zero points) of B1e: decode rows with a K split over
# several experts (E > 1: 2-4 experts of 1-2 column tiles leave SMs idle),
# Qwen3-30B-A3B's gate/up at decode rows (128 experts, no split), prefill
# rows with rows fastest (C <= 512) and columns fastest (640), ragged C and
# N (odd: scalar stores), groups 64 and 128
INT4B_EXPERT_CASES = [(4, 8, 200, 384, 128, True),
                      (2, 1, 128, 2048, 128, False),
                      (3, 65, 200, 512, 128, True), (5, 40, 99, 256, 64, True),
                      (2, 640, 328, 1024, 128, False),
                      (3, 300, 264, 512, 128, True),
                      (128, 8, 768, 2048, 128, False),
                      (16, 64, 2048, 768, 128, True),
                      # DeepSeek-V2-Lite's experts at group 64 (the
                      # kernels' half-k-tile groups): gate/up (N 1408, K
                      # 2048) and down (N 2048, K 1408) at a decode step's
                      # C (batch 64, 6 of 64 experts) and a serving chunk's
                      (64, 8, 1408, 2048, 64, False),
                      (64, 8, 2048, 1408, 64, False),
                      (64, 64, 1408, 2048, 64, True),
                      (64, 64, 2048, 1408, 64, False)]


def test_int4b_expert_cases_cover_designs_and_splits():
    """B1e's cases reach both designs with E > 1 and a K split in each."""
    seen = set()
    for e, c, n, k, _, _ in INT4B_EXPERT_CASES:
        _, splits, _ = w4.int4b_plan(c, n, k, e)
        if e > 1:
            seen.add((w4.int4b_design(c), splits > 1))
    assert seen >= {("decode", True), ("prefill", True), ("decode", False)}


def _expert_operands(gen, dev, e, c, n, k, g, asym, bits=4):
    """Stacked expert operands drawn on the card: x (E, C, K) bf16, words
    (E, N, K/8) int32 (or int8 (E, N, K) for bits 8), scales (and zero
    points) (E, K/g, N) f32."""
    if bits == 4:
        w = torch.randint(-(2**31), 2**31, (e, n, k // 8), generator=gen,
                          device=dev, dtype=torch.int64).to(torch.int32)
    else:
        w = torch.randint(-128, 128, (e, n, k), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int8)
    s = torch.rand((e, k // g, n), generator=gen, device=dev) * 2e-3 + 1e-3
    zp = (torch.randint(-8, 8, (e, k // g, n), generator=gen,
                        device=dev).float() if asym else None)
    x = torch.randn((e, c, k), generator=gen, device=dev).to(torch.bfloat16)
    return x, w, s, zp


@pytest.mark.parametrize("e,c,n,k,g,asym", INT4B_EXPERT_CASES)
def test_int4b_experts_grid(dev, e, c, n, k, g, asym):
    """B1e: every expert within the a8b rule of the plain f32 result, one
    launch for all experts; an expert's rows equal B1's on that expert
    alone where the plans agree."""
    gen = torch.Generator(device=dev).manual_seed(e * 131 + c + n + k)
    x, w, s, zp = _expert_operands(gen, dev, e, c, n, k, g, asym)
    kw = dict(n=n, k=k, group_size=g)
    before = w4.w4a16_experts_matmul.launches
    got = w4.w4a16_experts_matmul(x, w, s, zp, **kw)
    assert w4.w4a16_experts_matmul.launches == before + 1
    assert got.shape == (e, c, n)
    want = w4.w4a16_matmul_plain(x, w, s, zp, out_dtype=torch.float32, **kw)
    assert _within_a8b_rule(got, want)
    last = e - 1
    if w4.int4b_plan(c, n, k, e) == w4.int4b_plan(c, n, k):
        one = w4.w4a16_matmul(x[last], w[last], s[last],
                              zp[last] if asym else None, **kw)
        assert torch.equal(got[last], one)


# (E, C, N, K, group, zero points) of B2e: the Mixtral expert shape cut to
# two experts (a 320-row chunk), decode rows, ragged N, channel-wise and
# 64-wide groups
A8B_EXPERT_CASES = [(2, 320, 1024, 4096, 128, False),
                    (3, 64, 328, 2048, 128, True),
                    (2, 300, 198, 1344, 1344, True),
                    (4, 1, 200, 1024, 64, False)]


@pytest.mark.parametrize("e,c,n,k,g,asym", A8B_EXPERT_CASES)
def test_a8b_experts_grid(dev, e, c, n, k, g, asym):
    """B2e: the quantization pass bit for bit over all E * C rows, every
    expert within the a8b rule of the plain f32 result, one launch."""
    gen = torch.Generator(device=dev).manual_seed(e * 17 + c + n)
    x, w, s, zp = _expert_operands(gen, dev, e, c, n, k, g, asym)
    kw = dict(n=n, k=k, group_size=g)
    xq = torch.empty((e, c, k), dtype=torch.int8, device=dev)
    xs = torch.empty((e, c), dtype=torch.float32, device=dev)
    before = w4.w4a16_a8b_experts_matmul.launches
    got = w4.w4a16_a8b_experts_matmul(x, w, s, zp, xq=xq, xs=xs, **kw)
    assert w4.w4a16_a8b_experts_matmul.launches == before + 1
    xq_p, xs_p = w4.quantize_rows_a8b_plain(x)
    assert torch.equal(xq, xq_p) and torch.equal(xs, xs_p)
    want = w4.w4a16_matmul_plain(x, w, s, zp, mode="a8b",
                                 out_dtype=torch.float32, **kw)
    assert _within_a8b_rule(got, want)
    assert torch.equal(w4.w4a16_experts_matmul(x, w, s, zp, mode="a8b", **kw),
                       got)


# (E, C, N, K, group) of B9e: decode rows split over a cluster with E > 1,
# prefill rows, ragged N, groups 16 (a step) to 128, Qwen3-30B-A3B's gate
# at decode rows
W4E8_EXPERT_CASES = [(4, 5, 192, 384, 16), (2, 300, 136, 256, 16),
                     (3, 64, 200, 2048, 128), (2, 130, 256, 512, 128),
                     (3, 9, 99, 480, 48), (128, 8, 768, 2048, 128)]


def test_w4e8_expert_cases_cover_designs_and_splits():
    seen = set()
    for e, c, n, k, _ in W4E8_EXPERT_CASES:
        _, splits, _ = w4.wna16_plan(c, n, k, e)
        seen.add((w4.wna16_design(c), splits > 1))
    assert seen >= {("decode", True), ("prefill", True), ("decode", False)}


@pytest.mark.parametrize("e,c,n,k,g", W4E8_EXPERT_CASES)
def test_w4_e8_experts_grid(dev, e, c, n, k, g):
    """B9e: every expert within the a8b rule of the plain f32 result, one
    launch."""
    gen = torch.Generator(device=dev).manual_seed(e * 7 + c + n + k)
    x, w8, s, _ = _expert_operands(gen, dev, e, c, n, k, g, False, bits=8)
    kw = dict(n=n, k=k, group_size=g)
    before = w4.w4_e8_experts_matmul.launches
    got = w4.w4_e8_experts_matmul(x, w8, s, **kw)
    assert w4.w4_e8_experts_matmul.launches == before + 1
    assert _within_a8b_rule(got, w4.w4_e8_matmul_plain(
        x, w8, s, out_dtype=torch.float32, **kw))


def test_expert_wrappers_refuse_bad_operands(dev):
    """A ragged expert stack (K not a multiple of the group) and a
    non-contiguous weight stack raise before any launch."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x, w, s, _ = _expert_operands(gen, dev, 2, 8, 128, 256, 128, False)
    before = w4.w4a16_experts_matmul.launches
    with pytest.raises(ValueError, match="contiguous"):
        w4.w4a16_experts_matmul(x, w.transpose(1, 2).contiguous().transpose(
            1, 2), s, None, n=128, k=256, group_size=128)
    with pytest.raises(NotImplementedError, match="divide"):
        w4.w4a16_experts_matmul(x, w, s[:, :1].contiguous(), None, n=128,
                                k=256, group_size=192)
    assert w4.w4a16_experts_matmul.launches == before


# B5-L / B7-L, MLA's latent head: (K, V) widths of DeepSeek-V2-Lite (576,
# 512) and a narrow pair (128, 64); one query head, 16, 20, 32 (one head
# block of 64 rows) and DeepSeek-V2's 128 (two); every cache type; lengths
# 0, 1, 15-17 and 63-65 (each side of a 16-position tile) and S_pad - 1,
# an inactive row; the softmax scale of a true_d below K's width
LATENT_WIDTHS = [(576, 512), (128, 64)]


def _latent_case(rng, dev, rep, dk, dv, cache, s_pad, lens):
    q = _bf16(rng, len(lens), rep, dk, device=dev)
    nk = _bf16(rng, len(lens), 1, dk, device=dev)
    nv = _bf16(rng, len(lens), 1, dv, device=dev)
    scaled = cache != torch.bfloat16
    f32 = dict(dtype=torch.float32, device=dev)
    ks = torch.tensor([0.02], **f32) if scaled else None
    vs = torch.tensor([0.03], **f32) if scaled else None

    def make(*shape):
        if scaled:
            return _quantized_cache(rng, cache, *shape, device=dev)
        return _bf16(rng, *shape, device=dev)

    return q, nk, nv, ks, vs, make


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.float8_e4m3fn,
                                   torch.int8], ids=["bf16", "fp8", "int8"])
@pytest.mark.parametrize("dk,dv", LATENT_WIDTHS)
@pytest.mark.parametrize("rep", [1, 16, 20, 32, 128])
def test_latent_decode_grid(dev, rep, dk, dv, cache):
    """B5-L on the slab and B7-L on shuffled pages: every element within
    the a8b rule of the plain version's f32 result in the kernels' order,
    plus that version's bound on the probabilities' bf16 roundings
    (``LATENT_FLIP_REL``: a probability near a rounding midpoint may round
    the other way on the kernel's f32 scores), at the default ranges of
    the schedule (``latent_ranges``) and at 2 (segments of many tiles, a
    row cut between the ranges and merged); within TOL of the one-softmax
    plain version; inactive rows zero; cache bytes equal to the plain
    version's and changed at the step's positions only; one launch a
    call. Above 16 heads the output also equals the kernel's launches on
    each group of 16 heads alone, over the same ranges, bit for bit."""
    rng = np.random.default_rng(rep + dk + dv)
    s_pad, page, true_d = 448, 64, dk // 3
    lens = [0, 1, 15, 16, 17, 63, 64, 65, s_pad - 1, -1]
    B, P = len(lens), s_pad // page
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    live = [b for b in range(B) if lens[b] >= 0]
    q, nk, nv, ks, vs, make = _latent_case(rng, dev, rep, dk, dv, cache,
                                           s_pad, lens)
    kw = dict(layer=1, k_scale=ks, v_scale=vs, true_d=true_d)

    ranges = da.latent_ranges(rep, dev)

    def check(out, run_plain, caches, before, run_kernel):
        ordered, flip = run_plain([c.clone() for c in before],
                                  kernel_order=True, out_dtype=torch.float32,
                                  flip_rel=da.LATENT_FLIP_REL)[0]
        assert _within_a8b_rule(out[live], ordered[live], flip[live])
        two = run_kernel(q, [c.clone() for c in before], 2)
        ordered, flip = run_plain([c.clone() for c in before],
                                  kernel_order=True, out_dtype=torch.float32,
                                  flip_rel=da.LATENT_FLIP_REL, ranges=2)[0]
        assert _within_a8b_rule(two[live], ordered[live], flip[live])
        if rep > 16:
            groups = [run_kernel(q[:, g:g + 16].contiguous(),
                                 [c.clone() for c in before], ranges)
                      for g in range(0, rep, 16)]
            assert torch.equal(out, torch.cat(groups, dim=1))
        one = run_plain([c.clone() for c in before])[0]
        _close(out[live], one[live])
        assert out.shape == (B, rep, dv) and not out[B - 1].any()
        plain_caches = [c.clone() for c in before]
        run_plain(plain_caches)
        for got, want in zip(caches, plain_caches):
            assert _same_bytes(got, want)

    # the slab
    ck, cv = make(2, B, 1, s_pad, dk), make(2, B, 1, s_pad, dv)
    before = [ck.clone(), cv.clone()]
    count = da.decode_attention.latent_launches
    out, _, _ = da.decode_attention(q, nk, nv, ck, cv, lengths, **kw)
    assert da.decode_attention.latent_launches == count + 1
    check(out, lambda c, **o: da.latent_decode_attention_plain(
        q, nk, nv, *c, lengths, **kw, **o), (ck, cv), before,
        lambda qg, c, r: da._latent_decode(qg, nk, nv, *c, lengths, 1, ks,
                                           vs, true_d, ranges=r)[0])
    changed = torch.nonzero((ck.view(torch.uint8) != before[0].view(
        torch.uint8)).any(-1)).tolist()
    assert sorted(map(tuple, changed)) == sorted(
        (1, b, 0, lens[b]) for b in live)

    # the pool through shuffled page tables (the inactive row on page 0)
    tables = rng.permutation(np.arange(1, B * P + 1)).astype(np.int32)
    tables = tables.reshape(B, P)
    tables[B - 1] = 0
    tables_d = torch.from_numpy(tables).to(dev)
    pk, pv = make(2, B * P + 1, 1, page, dk), make(2, B * P + 1, 1, page, dv)
    before = [pk.clone(), pv.clone()]
    count = pd.paged_decode_attention.latent_launches
    out_p, _, _ = pd.paged_decode_attention(q, nk, nv, pk, pv, tables_d,
                                            lengths, **kw)
    assert pd.paged_decode_attention.latent_launches == count + 1
    check(out_p, lambda c, **o: pd.paged_decode_attention_plain(
        q, nk, nv, *c, tables_d, lengths, **kw, **o), (pk, pv), before,
        lambda qg, c, r: pd._latent_paged_decode(
            qg, nk, nv, *c, tables_d, lengths, 1, ks, vs, true_d,
            ranges=r)[0])
    changed = torch.nonzero((pk.view(torch.uint8) != before[0].view(
        torch.uint8)).any(-1)).tolist()
    assert sorted(map(tuple, changed)) == sorted(
        (1, int(tables[b, lens[b] // page]), 0, lens[b] % page) for b in live)


def test_latent_decode_pages_smaller_than_a_tile(dev):
    """B7-L with 16-position pages (one page a 16-position tile; the
    kernels take pages that are multiples of 16) gives the bits of B5-L
    on the same rows laid out densely."""
    rng = np.random.default_rng(21)
    dk, dv, page, s_pad = 576, 512, 16, 256
    lens = [5, 31, 32, 200, -1]
    B, P = len(lens), s_pad // page
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    q, nk, nv, _, _, make = _latent_case(rng, dev, 16, dk, dv,
                                         torch.bfloat16, s_pad, lens)
    tables = rng.permutation(np.arange(1, B * P + 1)).astype(np.int32)
    tables = tables.reshape(B, P)
    tables[B - 1] = 0
    tables_d = torch.from_numpy(tables).to(dev)
    pk, pv = make(1, B * P + 1, 1, page, dk), make(1, B * P + 1, 1, page, dv)
    dense = [p[0][tables_d.long()].permute(0, 2, 1, 3, 4).reshape(
        B, 1, s_pad, p.shape[-1])[None].contiguous() for p in (pk, pv)]
    out_p, _, _ = pd.paged_decode_attention(q, nk, nv, pk, pv, tables_d,
                                            lengths, layer=0, true_d=192)
    out_d, _, _ = da.decode_attention(q, nk, nv, *dense, lengths, layer=0,
                                      true_d=192)
    assert torch.equal(out_p[:-1], out_d[:-1])


def test_latent_decode_more_rows_than_a_grid_dimension(dev):
    """B7-L and its merge pass at 65537 rows (more than a CUDA grid's y or
    z dimension holds), 20 heads (two head groups) and the narrow latent
    widths (K 128, V 64): the live rows, the first and the last eight,
    equal the plain version run on them alone by the rule of
    ``test_latent_decode_grid``, the other rows are inactive and zero, and
    the pool's bytes equal the plain version's."""
    rng = np.random.default_rng(23)
    gen = torch.Generator(device=dev).manual_seed(23)
    B, h, dk, dv, page, P = 65537, 20, 128, 64, 64, 5
    live = [0, *range(B - 8, B)]
    lens = np.full(B, -1, np.int32)
    lens[live] = [7, 0, 63, 255, 256, 257, 300, 319, 5]
    tables = np.zeros((B, P), np.int32)
    tables[live] = rng.permutation(np.arange(1, len(live) * P + 1)).reshape(
        len(live), P)
    q, nk, nv = (torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16) for shape in ((B, h, dk), (B, 1, dk), (B, 1, dv)))
    pk, pv = (_bf16(rng, 1, len(live) * P + 1, 1, page, d, device=dev)
              for d in (dk, dv))
    before = [pk.clone(), pv.clone()]
    lengths, tables_d = (torch.from_numpy(a).to(dev) for a in (lens, tables))
    count = pd.paged_decode_attention.latent_launches
    out, _, _ = pd.paged_decode_attention(q, nk, nv, pk, pv, tables_d,
                                          lengths, true_d=48)
    assert pd.paged_decode_attention.latent_launches == count + 1
    rows = torch.tensor(live, device=dev)
    plain = [c.clone() for c in before]
    ordered, flip = pd.paged_decode_attention_plain(
        q[rows], nk[rows], nv[rows], *plain, tables_d[rows], lengths[rows],
        true_d=48, kernel_order=True, out_dtype=torch.float32,
        flip_rel=da.LATENT_FLIP_REL)[0]
    assert _within_a8b_rule(out[rows], ordered, flip)
    inactive = torch.ones(B, dtype=torch.bool, device=dev)
    inactive[rows] = False
    assert not out[inactive].any()
    for got, want in zip((pk, pv), plain):
        assert _same_bytes(got, want)


def test_latent_decode_refuses_operands(dev):
    """A K width that is no multiple of 64, V wider than K, a per-head
    scale and a page that is no multiple of 16 raise before any launch
    (any number of query heads is served: ``test_latent_decode_grid``)."""
    rng = np.random.default_rng(22)
    lengths = torch.tensor([3], dtype=torch.int32, device=dev)
    count = da.decode_attention.latent_launches
    for h, dk, dv in ((16, 560, 512), (16, 512, 576)):
        q = _bf16(rng, 1, h, dk, device=dev)
        nk, nv = _bf16(rng, 1, 1, dk, device=dev), _bf16(rng, 1, 1, dv,
                                                         device=dev)
        ck, cv = (_bf16(rng, 1, 1, 1, 64, d, device=dev) for d in (dk, dv))
        with pytest.raises(NotImplementedError):
            da.decode_attention(q, nk, nv, ck, cv, lengths, layer=0)
    q = _bf16(rng, 1, 16, 576, device=dev)
    nk, nv = _bf16(rng, 1, 1, 576, device=dev), _bf16(rng, 1, 1, 512,
                                                      device=dev)
    ck, cv = (_quantized_cache(rng, torch.int8, 1, 1, 1, 64, d, device=dev)
              for d in (576, 512))
    two = torch.tensor([0.02, 0.03], device=dev).reshape(2, 1, 1)
    with pytest.raises(NotImplementedError):
        da.decode_attention(q, nk, nv, ck, cv, lengths, layer=0, k_scale=two,
                            v_scale=two)
    assert da.decode_attention.latent_launches == count
    # a page that is no multiple of the 16-position tile
    pk, pv = (_bf16(rng, 1, 3, 1, 8, d, device=dev) for d in (576, 512))
    tables = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)
    count = pd.paged_decode_attention.latent_launches
    with pytest.raises(ValueError, match="multiple of 16"):
        pd.paged_decode_attention(q, nk, nv, pk, pv, tables, lengths)
    assert pd.paged_decode_attention.latent_launches == count


def test_ring_k_slices_sum_to_b1(dev):
    """The quantized ring's K-slices (``parallel.overlap.ring_k_slices``,
    cut once per weight): their two B1 launches, summed in f32, against B1
    on the whole (N/2, K) shard, within the bf16 rounding of the three
    outputs plus 1e-4 max|y|."""
    import dataclasses

    from torch_dist_worker import ring_shard

    from compressed_tensors_tpu_torch.parallel.overlap import ring_k_slices

    qt = ring_shard(0)
    qt = dataclasses.replace(qt, kernel_packed=qt.kernel_packed.to(dev),
                             kernel_scales=qt.kernel_scales.to(dev))
    n, k, g = qt.kernel_meta[1:]
    x = _bf16(np.random.default_rng(23), 8, k, device=dev)
    whole = w4.w4a16_matmul(x, qt.kernel_packed, qt.kernel_scales, None,
                            n=n, k=k, group_size=g).float()
    slices = ring_k_slices(qt, 2)
    assert ring_k_slices(qt, 2) is slices
    parts = [w4.w4a16_matmul(x[:, s * ks:(s + 1) * ks].contiguous(), wp, sc,
                             zp, n=n, k=ks, group_size=g).float()
             for s, (wp, sc, zp, ks) in enumerate(slices)]
    got = parts[0] + parts[1]
    tol = 2**-8 * (parts[0].abs() + parts[1].abs() + whole.abs()) \
        + 1e-4 * whole.abs().max()
    assert bool(((got - whole).abs() <= tol).all())
