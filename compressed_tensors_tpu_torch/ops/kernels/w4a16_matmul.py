"""W4A16 group-quantized matmul: y = x @ W^T with W kept packed.

Replaces ``compressed_tensors_tpu/ops/kernels/w4a16_matmul.py:w4a16_matmul``
(mode ``int4b``) with the hand-written Hopper kernel in
``csrc/w4a16_matmul.cu``.

Weight layout: the checkpoint's pack-quantized words, (N, K/8) int32 with
nibble j of word w holding u = q + 8 of column 8w + j -- already K-major
per output row, which is what the kernel's tensor-core B operand wants, so
the layout needs no repacking. Group scales (and zero points) are stored
(K/group, N) f32 so a k-tile reads one contiguous row of them.

Bound on the H100: at decode (M = 64) the packed weight bytes, K*N/2 read
once; at prefill (M = B*S) the 2*M*N*K bf16 tensor-core operations.
``int4b_plan`` picks one of the kernel's two designs by M (see the source
note in the .cu file), both on ``wgmma`` over each k-tile's words decoded
once a block into a bf16 tile: decode rows (M <= 64) as y^T = W x^T with
128 weight rows a block; prefill rows over 128 x 192 tiles. Both
split K over the blocks of a cluster and sum the splits through
distributed shared memory.

Mode ``a8b`` (int8 activations, the TPU kernel's mode for prefill row
counts) is the second entry point of the same source, launched by
``w4a16_a8b_matmul``: a row pass quantizes x per token (absmax / 127,
clip to +-127, one read of the row), then a GEMM on ``wgmma`` over 128 x
128 tiles decodes each k-tile of the packed words once a block into exact
int8 values, sums each group exactly in int32, scales it in f32 and
applies the row's x scale once; K is split over a cluster by ``a8b_plan``.
Bound: the 2*M*N*K int8 operations at prefill chunks.

Two more wrappers run the layouts without int4 words on the ``wgmma``
kernels of ``csrc/wna16_matmul.cu``, in the design ``wna16_plan`` picks by
M (decode rows up to 64: y^T = W x^T with each warp's decoded weight rows
as the register A operand; prefill rows: 128 x 128 tiles over a decoded
bf16 tile), K split over the blocks of a cluster:

- ``w4a16_fp4_matmul`` replaces mode ``fp4`` of the same TPU function
  (NVFP4 / MXFP4). It keeps the checkpoint's (N, K/2) uint8 E2M1 codes
  (low nibble = even column) and (K/g, N) f32 scales, g = 16 or 32. Each
  weight becomes bf16(E2M1(code) * scale), as the TPU kernel rounds its
  scaled tile to x's dtype, then one bf16 dot with f32 accumulation and a
  single bf16 write. Bound: the code and scale bytes at decode, the
  2*M*N*K bf16 operations at prefill.
- ``w4_e8_matmul`` replaces ``w4_e8_matmul`` (the grouped-int8 kernel that
  serves W2-W8A16 and W4A16 under ``w4_layout="e8"``). It keeps (N, K)
  signed int8 q - zp and (K/g, N) f32 scales, g a multiple of 16; each
  group's f32 partial (int8 -> bf16 is exact) is scaled into an f32
  accumulator. Bound: the int8 weight bytes at decode, the bf16
  operations at prefill.

``w4a16_planes_matmul`` replaces modes ``int4``, ``a8`` and ``mat`` of the
same TPU function, which run on its int32 8-plane layout
(``w4_layout="packed"``). The layout is the JAX package's:
``repack_w4_for_kernel`` turns the (N, K_pad) offset codes u = q + 8 into
(K_pad/8, N) int32 words, K_pad a multiple of the k-tile TK = 8 * group,
word (t*g + r, n) holding in nibble plane j the code of k-position
t*8g + j*g + r, so each plane of a k-tile is one quant group. Scales and
zero points are (K_pad/g, N) f32, padded groups at scale 0 (code 8). The
three modes, one C entry point each in ``csrc/w4a16_planes.cu``:

- ``int4``: per plane, x_j . (u_j - 8 - zp_j) with x in bf16 and the
  folded codes exact integers in [-15, 15], f32 sums, times s_j (the TPU
  kernel dots u_j and subtracts the offset afterwards as the rank-8
  correction sum_j sum(x_j) * (8 + zp_j) * s_j: the same value, less
  exactly, since it cancels two large terms).
- ``a8``: x quantized per row to int8 as in ``a8b``; exact int32 dots
  with the same folded codes times s_j, everything times the row's scale.
- ``mat``: each plane's scaled tile bf16(u_j * s_j) and one deep dot; the
  offset is left out of the tile and subtracted as the rank-8 correction,
  so the tile rounds u*s as the TPU kernel does, not (u - 8 - zp)*s.
  Zero points must be integers, as a checkpoint's are.

Bound: the checkpoint bytes at decode rows (codes, bf16 scales, 4-bit zero
points), the 2*M*N*K bf16 (``int4``, ``mat``) or int8 (``a8``) operations
at prefill rows.

The MoE layer's stacked experts take three expert-batched entry points,
each one launch for all E experts of an (E, C, K) dispatch buffer with the
expert index in grid y (the K-split cluster spans grid z only), the design
picked by C rows and the split counted over all E experts' blocks:
``w4a16_experts_matmul`` (int4b over (E, N, K/8) words, the replacement
of the JAX package's ``jax.vmap`` of ``w4a16_matmul`` in
``quantized_matmul_experts``), its mode a8b ``w4a16_a8b_experts_matmul``,
and ``w4_e8_experts_matmul`` (the vmapped ``w4_e8_matmul``). Their plain
versions are the 2-D ones, which take a leading expert dim.

Each wrapper launches its kernel for CUDA tensors and uses its plain
version only for CPU tensors.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from compressed_tensors_tpu_torch.ops.fp4_pack import unpack_fp4_from_uint8
from compressed_tensors_tpu_torch.ops.kernels import _build
from compressed_tensors_tpu_torch.ops.pack import unpack_from_int32

__all__ = ["w4a16_matmul", "w4a16_a8b_matmul", "w4a16_matmul_plain",
           "w4a16_experts_matmul", "w4a16_a8b_experts_matmul",
           "w4_e8_experts_matmul",
           "int4b_design", "int4b_plan", "a8b_plan",
           "quantize_rows_a8b_plain", "w4a16_fp4_matmul",
           "w4a16_fp4_matmul_plain", "w4_e8_matmul", "w4_e8_matmul_plain",
           "wna16_design", "wna16_plan", "choose_k_tile", "padded_k",
           "retile_groups",
           "repack_w4_for_kernel", "w4a16_planes_matmul",
           "w4a16_planes_matmul_plain", "PLANE_MODES"]

_BK = 64
_TILE = 64
_SMS = 132


def _dequantized_weight(w_packed, scales, zp, n, k, group_size):
    """(..., N, K) f32 weight: (q - zp) * s, for (..., N, K/8) words and
    (..., K/g, N) scales and zero points (a leading expert dim rides
    along)."""
    q = unpack_from_int32(w_packed, 4, (n, k)).to(torch.float32)
    s = _group_scales(scales, group_size)
    if zp is not None:
        q = q - _group_scales(zp, group_size)
    return q * s


def quantize_rows_a8b_plain(x):
    """Mode a8b's per-row int8 quantization of x: (xq int8, scale f32 of
    shape x.shape[:-1]) with scale = max(absmax, 1e-8) / 127 and xq =
    clip(round(x / scale), -127, 127), rounding half to even."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1).clamp_min(1e-8)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, which is not the IEEE division the kernel does
    scale = absmax / torch.full_like(absmax, 127.0)
    xq = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return xq.to(torch.int8), scale


def w4a16_matmul_plain(x, w_packed, scales, zp, *, n, k, group_size,
                       mode="int4b", out_dtype=None):
    """Plain PyTorch version: dequantize the weight in f32, one f32 matmul,
    cast to ``out_dtype`` (x's dtype by default). Mode "a8b" first
    quantizes x per row to int8 (``quantize_rows_a8b_plain``), as the TPU
    kernel's a8b mode. Stacked experts -- x (E, C, K), words (E, N, K/8),
    scales and zero points (E, K/g, N) -- give y (E, C, N), one batched
    matmul (the plain version of ``w4a16_experts_matmul``)."""
    w = _dequantized_weight(w_packed, scales, zp, n, k, group_size)
    if mode == "a8b":
        xq, x_scale = quantize_rows_a8b_plain(x)
        y = (xq.to(torch.float32) @ w.transpose(-1, -2)) * x_scale[..., None]
    elif mode == "int4b":
        y = x.to(torch.float32) @ w.transpose(-1, -2)
    else:
        raise ValueError(f"unknown w4a16 mode {mode!r}")
    return y.to(out_dtype or x.dtype)


def _split_k(m: int, n: int, k: int, unit_tiles: int, *, tile_m: int = _TILE,
             tile_n: int = _TILE) -> tuple[int, int]:
    """(splits, k-tiles per split) of the plane-layout kernel: split K over
    up to 4 blocks when the (M, N) grid of ``tile_m`` x ``tile_n`` blocks
    leaves most SMs idle; splits cut at multiples of ``unit_tiles`` k-tiles
    (one k-tile of 8 groups)."""
    tiles = -(-k // _BK)
    units = -(-tiles // unit_tiles)
    blocks = -(-n // tile_n) * -(-m // tile_m)
    want = min(4, max(1, _SMS // blocks), units)
    tiles_per_split = -(-units // want) * unit_tiles
    return -(-tiles // tiles_per_split), tiles_per_split


# mode int4b (csrc/w4a16_matmul.cu, namespace int4b): 64-deep k-tiles;
# decode rows take 128 weight rows a block (two blocks an SM), prefill rows
# 128 x 192 tiles; at most 8 blocks of a cluster share K
_INT4B_BK = 64
_INT4B_DECODE_ROWS, _INT4B_DECODE_BN = 64, 128
_INT4B_PREFILL_BM, _INT4B_PREFILL_BN = 128, 192


def int4b_design(m: int) -> str:
    """Mode int4b's design for M rows: "decode" (M <= 64: the weight bytes
    bound it) or "prefill" (128-row tiles: the tensor-core operations)."""
    return "decode" if m <= _INT4B_DECODE_ROWS else "prefill"


@functools.lru_cache(maxsize=1024)
def int4b_plan(m: int, n: int, k: int,
               experts: int = 1) -> tuple[int, int, int]:
    """(rows a block, K splits, k-tiles a split) of mode int4b, as
    ``tools/int4b_sweep.py`` measured them on the H100.
    Decode rows take 16, 32 or 64 rows (the fewest that hold M) and 128
    weight rows a block, two blocks an SM, and split K over the largest
    power-of-two cluster (up to 8) whose blocks fit in one wave. Prefill
    rows take 128 x 192 tiles, one an SM, and the split with the least
    estimated time, the number of waves times a block's k-tiles plus 4 for
    its pipeline's fill and its epilogue, the fewer splits on a tie. The
    split is then as many blocks as its k-tiles per block leave none
    empty. Each split scales its own part of a group's sum, so a split may
    cut a group. An expert-batched launch (``experts`` > 1) picks the
    design by the M rows of one expert and counts the blocks of all of
    them. Cached: the wrapper asks once a call."""
    tiles = -(-k // _INT4B_BK)
    if int4b_design(m) == "decode":
        bm = next(b for b in (16, 32, 64) if m <= b)
        blocks = -(-n // _INT4B_DECODE_BN) * experts
        split = max(s for s in (1, 2, 4, 8)
                    if s == 1 or (s <= tiles and blocks * s <= 2 * _SMS))
    else:
        bm = _INT4B_PREFILL_BM
        blocks = -(-n // _INT4B_PREFILL_BN) * -(-m // bm) * experts

        def cost(s):
            return -(-blocks * s // _SMS) * (-(-tiles // s) + 4)

        split = min((s for s in (1, 2, 4, 8) if s <= tiles), key=cost)
    per = -(-tiles // split)
    return bm, -(-tiles // per), per


# mode a8b's GEMM (csrc/w4a16_matmul.cu, namespace a8b): 128 x 128 tiles,
# 128-deep k-tiles, at most 8 blocks of a cluster sharing K
_A8B_BM = _A8B_BN = _A8B_BK = 128


def a8b_plan(m: int, n: int, k: int, experts: int = 1) -> tuple[int, int]:
    """(K splits, k-tiles a split) of mode a8b's GEMM: the split with the
    least estimated time, the number of waves of 128 x 128 blocks (one an
    SM; M rows of each of ``experts``) times a block's 128-deep k-tiles
    plus 4 for its pipeline's fill and its epilogue, the fewer splits on a
    tie; then as many blocks as its k-tiles per block leave none empty."""
    tiles = -(-k // _A8B_BK)
    blocks = -(-n // _A8B_BN) * -(-m // _A8B_BM) * experts

    def cost(s):
        return -(-blocks * s // _SMS) * (-(-tiles // s) + 4)

    split = min((s for s in (1, 2, 4, 8) if s <= tiles), key=cost)
    per = -(-tiles // split)
    return -(-tiles // per), per


def _check(x, w_packed, scales, zp, n, k, group_size):
    """Raise on operands the CUDA kernels do not take."""
    if x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"x must be (M, {k}) bf16, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if k % _BK or group_size % _BK:
        raise NotImplementedError(
            f"w4a16 kernel needs K and group_size multiples of {_BK}, got "
            f"K={k}, group_size={group_size}")
    if (w_packed.dtype != torch.int32 or tuple(w_packed.shape) != (n, k // 8)
            or scales.dtype != torch.float32
            or tuple(scales.shape) != (k // group_size, n)
            or (zp is not None and (zp.dtype != torch.float32
                                    or zp.shape != scales.shape))):
        raise ValueError("w4a16 kernel layout mismatch")
    tensors = [x, w_packed, scales] + ([zp] if zp is not None else [])
    if any(t.device != x.device or not t.is_contiguous() for t in tensors):
        raise ValueError("w4a16 operands must be contiguous on one device")


def w4a16_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                 scales: torch.Tensor, zp: torch.Tensor | None, *,
                 n: int, k: int, group_size: int,
                 mode: str = "int4b") -> torch.Tensor:
    """y (M, N) = x (M, K) @ W^T for W packed (N, K/8) int32 with (K/g, N)
    f32 scales and optional (K/g, N) f32 zero points."""
    if x.device.type == "cpu":
        return w4a16_matmul_plain(x, w_packed, scales, zp, n=n, k=k,
                                  group_size=group_size, mode=mode)
    if mode == "a8b":
        return w4a16_a8b_matmul(x, w_packed, scales, zp, n=n, k=k,
                                group_size=group_size)
    if mode != "int4b":
        raise ValueError(f"unknown w4a16 mode {mode!r}")
    _check(x, w_packed, scales, zp, n, k, group_size)
    if x.data_ptr() % 16 or w_packed.data_ptr() % 16:
        raise ValueError("w4a16 kernel copies x and the packed weight 16 "
                         "bytes at a time: both must be 16-byte aligned")
    m = x.shape[0]
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    bm, splits, per = int4b_plan(m, n, k)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.ct_w4a16_matmul(
            x.data_ptr(), w_packed.data_ptr(), scales.data_ptr(),
            zp.data_ptr() if zp is not None else None, y.data_ptr(),
            m, n, k, group_size, bm, splits, per,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "w4a16_matmul")
    w4a16_matmul.launches += 1
    return y


w4a16_matmul.launches = 0


def w4a16_a8b_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                     scales: torch.Tensor, zp: torch.Tensor | None, *,
                     n: int, k: int, group_size: int,
                     xq: torch.Tensor | None = None,
                     xs: torch.Tensor | None = None) -> torch.Tensor:
    """Mode ``a8b`` of ``w4a16_matmul``: x quantized per row to int8, int8
    group dots, the same operands and result shape.

    :param xq: optional (M, K) int8 buffer for the kernel's quantized rows
    :param xs: optional (M,) f32 buffer for their scales; pass both to read
        the quantization pass back
    """
    if x.device.type == "cpu":
        return w4a16_matmul_plain(x, w_packed, scales, zp, n=n, k=k,
                                  group_size=group_size, mode="a8b")
    _check(x, w_packed, scales, zp, n, k, group_size)
    m = x.shape[0]
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    if xq is None:
        xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    if xs is None:
        xs = torch.empty((m,), dtype=torch.float32, device=x.device)
    if (xq.dtype != torch.int8 or tuple(xq.shape) != (m, k)
            or xs.dtype != torch.float32 or tuple(xs.shape) != (m,)
            or not (xq.is_contiguous() and xs.is_contiguous())
            or xq.device != x.device or xs.device != x.device):
        raise ValueError("a8b scratch must be (M, K) int8 and (M,) f32, "
                         "contiguous on x's device")
    if w_packed.data_ptr() % 16 or xq.data_ptr() % 16:
        raise ValueError("a8b kernel copies the packed weight and the "
                         "quantized rows 16 bytes at a time: both must be "
                         "16-byte aligned")
    splits, per = a8b_plan(m, n, k)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.ct_w4a16_a8b_matmul(
            x.data_ptr(), w_packed.data_ptr(), scales.data_ptr(),
            zp.data_ptr() if zp is not None else None, y.data_ptr(),
            xq.data_ptr(), xs.data_ptr(), m, n, k, group_size, splits, per,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "w4a16_a8b_matmul")
    w4a16_a8b_matmul.launches += 1
    return y


w4a16_a8b_matmul.launches = 0


# ---- fp4 codes and int8-expanded weights ------------------------------ #

def _group_scales(scales, group_size):
    """(..., K/g, N) scales -> (..., N, K) f32, one per weight."""
    return scales.to(torch.float32).transpose(-1, -2).repeat_interleave(
        group_size, dim=-1)


def w4a16_fp4_matmul_plain(x, codes, scales, *, n, k, group_size,
                           out_dtype=None):
    """Plain version of mode fp4: each weight rounded to x's compute type
    (bf16 for bf16 x, else f32) as bf16(E2M1(code) * scale), then one f32
    matmul, cast to ``out_dtype`` (x's dtype by default)."""
    w = unpack_fp4_from_uint8(codes, n, k, dtype=torch.float32) * \
        _group_scales(scales, group_size)
    w = w.to(torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32)
    y = x.to(torch.float32) @ w.to(torch.float32).t()
    return y.to(out_dtype or x.dtype)


def w4_e8_matmul_plain(x, w8, scales, *, n, k, group_size, out_dtype=None):
    """Plain version of the grouped-int8 matmul: the (N, K) int8 values
    times their group scales in f32, one f32 matmul, cast to
    ``out_dtype`` (x's dtype by default). Stacked experts -- x (E, C, K),
    w8 (E, N, K), scales (E, K/g, N) -- give y (E, C, N) (the plain
    version of ``w4_e8_experts_matmul``)."""
    w = w8.to(torch.float32) * _group_scales(scales, group_size)
    return (x.to(torch.float32) @ w.transpose(-1, -2)).to(
        out_dtype or x.dtype)


# the grouped-weight kernels (csrc/wna16_matmul.cu): 64-deep k-tiles, 128
# output columns a block, at most 8 blocks of a cluster sharing K
_WNA16_BK = 64
_WNA16_BN = 128
_DECODE_ROWS = 64


def wna16_design(m: int) -> str:
    """The grouped-weight kernels' design for M rows: "decode" (M <= 64:
    the weight bytes bound it) or "prefill" (128-row tiles: the
    tensor-core operations bound it)."""
    return "decode" if m <= _DECODE_ROWS else "prefill"


def wna16_plan(m: int, n: int, k: int,
               experts: int = 1) -> tuple[int, int, int]:
    """(rows a block, K splits, k-tiles a split) of the grouped-weight
    kernels. Decode rows take a block of 16, 32 or 64 rows (the fewest
    that hold M) and split K over a cluster of up to 8 blocks as far as two
    blocks an SM allow (the split that measured fastest at every 8B linear
    on the H100); prefill rows take 128 and one block an SM, and the split
    with the least estimated time, the number of waves of blocks times a
    block's k-tiles plus 4 for its pipeline's fill and its epilogue (the
    fewer splits on a tie). The split is then as many blocks as its
    k-tiles per block leave none empty. An expert-batched launch
    (``experts`` > 1) picks the design by the M rows of one expert and
    counts the blocks of all of them."""
    tiles = -(-k // _WNA16_BK)
    if wna16_design(m) == "decode":
        bm = next(b for b in (16, 32, 64) if m <= b)
        blocks = -(-n // _WNA16_BN) * experts
        split = max(s for s in (1, 2, 4, 8)
                    if s == 1 or (s <= tiles and blocks * s <= 2 * _SMS))
    else:
        bm = 128
        blocks = -(-n // _WNA16_BN) * -(-m // bm) * experts

        def cost(s):
            return -(-blocks * s // _SMS) * (-(-tiles // s) + 4)

        split = min((s for s in (1, 2, 4, 8) if s <= tiles), key=cost)
    per = -(-tiles // split)
    return bm, -(-tiles // per), per


def _launch_wna16(wrapper, x, w, scales, n, k, group_size, w_dtype, w_cols,
                  k_align):
    """Check the operands of a grouped-weight entry point, launch it with
    the design and split of ``wna16_plan``, count the launch on
    ``wrapper`` and return y (M, N) bf16."""
    entry = wrapper.__name__
    if x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"x must be (M, {k}) bf16, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if group_size % 16 or k % group_size or k % k_align:
        raise NotImplementedError(
            f"{entry} needs a group size that is a multiple of 16 and "
            f"divides K, and K a multiple of {k_align}; got K={k}, "
            f"group_size={group_size}")
    if (w.dtype != w_dtype or tuple(w.shape) != (n, w_cols)
            or scales.dtype != torch.float32
            or tuple(scales.shape) != (k // group_size, n)):
        raise ValueError(f"{entry}: weight must be ({n}, {w_cols}) "
                         f"{w_dtype} and scales ({k // group_size}, {n}) f32")
    if x.shape[0] * k >= 2**31 or n * w_cols >= 2**31:
        raise NotImplementedError(f"{entry} indexes x and the weight with "
                                  "32-bit offsets: M*K and the weight's "
                                  "elements must stay below 2^31")
    if any(t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16
           for t in (x, w, scales)):
        raise ValueError(f"{entry} operands must be contiguous, 16-byte "
                         "aligned and on one device")
    m = x.shape[0]
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    bm, splits, tiles_per_split = wna16_plan(m, n, k)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = getattr(lib, "ct_" + entry)(
            x.data_ptr(), w.data_ptr(), scales.data_ptr(), y.data_ptr(),
            m, n, k, group_size, bm, splits, tiles_per_split,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry)
    wrapper.launches += 1
    return y


def w4a16_fp4_matmul(x: torch.Tensor, codes: torch.Tensor,
                     scales: torch.Tensor, *, n: int, k: int,
                     group_size: int) -> torch.Tensor:
    """y (M, N) = x (M, K) @ W^T for NVFP4 / MXFP4 weights: (N, K/2) uint8
    E2M1 codes, low nibble first, and (K/g, N) f32 scales."""
    if x.device.type == "cpu":
        return w4a16_fp4_matmul_plain(x, codes, scales, n=n, k=k,
                                      group_size=group_size)
    return _launch_wna16(w4a16_fp4_matmul, x, codes, scales, n, k,
                         group_size, torch.uint8, k // 2, 32)


w4a16_fp4_matmul.launches = 0


def w4_e8_matmul(x: torch.Tensor, w8: torch.Tensor, scales: torch.Tensor,
                 *, n: int, k: int, group_size: int) -> torch.Tensor:
    """y (M, N) = x (M, K) @ W^T for grouped int weights expanded to (N, K)
    signed int8 q - zp, with (K/g, N) f32 scales."""
    if x.device.type == "cpu":
        return w4_e8_matmul_plain(x, w8, scales, n=n, k=k,
                                  group_size=group_size)
    return _launch_wna16(w4_e8_matmul, x, w8, scales, n, k, group_size,
                         torch.int8, k, 16)


w4_e8_matmul.launches = 0


# ---- expert-batched launches (the MoE layer's stacked experts) --------- #

def _check_experts(entry, x, w, scales, zp, n, k, group_size, w_dtype,
                   w_cols):
    """Raise on expert-stacked operands the CUDA kernels do not take: x
    (E, C, K) bf16, weights (E, N, w_cols), scales and zero points (E,
    K/g, N) f32, all contiguous on one device. Each expert's block of x,
    the weights and y then starts where the kernels' 16-byte copies need
    it, since K is a multiple of 16 and the group divides K."""
    if x.dtype != torch.bfloat16 or x.dim() != 3 or x.shape[2] != k:
        raise ValueError(f"x must be (E, C, {k}) bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    e = x.shape[0]
    if k % group_size:
        raise NotImplementedError(f"{entry} needs the group size to divide "
                                  f"K; got K={k}, group_size={group_size}")
    if (w.dtype != w_dtype or tuple(w.shape) != (e, n, w_cols)
            or scales.dtype != torch.float32
            or tuple(scales.shape) != (e, k // group_size, n)
            or (zp is not None and (zp.dtype != torch.float32
                                    or zp.shape != scales.shape))):
        raise ValueError(f"{entry}: weights must be ({e}, {n}, {w_cols}) "
                         f"{w_dtype}, scales and zero points ({e}, "
                         f"{k // group_size}, {n}) f32")
    if e > 65535:
        raise NotImplementedError(f"{entry} takes at most 65535 experts")
    tensors = [x, w, scales] + ([zp] if zp is not None else [])
    if any(t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16
           for t in tensors):
        raise ValueError(f"{entry} operands must be contiguous, 16-byte "
                         "aligned and on one device")


def w4a16_experts_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                         scales: torch.Tensor, zp: torch.Tensor | None, *,
                         n: int, k: int, group_size: int,
                         mode: str = "int4b") -> torch.Tensor:
    """y (E, C, N), y[e] = x[e] @ W[e]^T for every expert in one launch:
    x the (E, C, K) dispatch buffer, W[e] packed (E, N, K/8) int32 with
    (E, K/g, N) f32 scales and optional zero points. Mode "int4b" runs
    ``ct_w4a16_matmul_experts`` (counted on this function's ``launches``),
    mode "a8b" ``w4a16_a8b_experts_matmul``. The design and split come
    from C rows and all E experts' blocks (``int4b_plan``)."""
    if x.device.type == "cpu":
        return w4a16_matmul_plain(x, w_packed, scales, zp, n=n, k=k,
                                  group_size=group_size, mode=mode)
    if mode == "a8b":
        return w4a16_a8b_experts_matmul(x, w_packed, scales, zp, n=n, k=k,
                                        group_size=group_size)
    if mode != "int4b":
        raise ValueError(f"unknown w4a16 mode {mode!r}")
    _check_experts("w4a16_experts_matmul", x, w_packed, scales, zp, n, k,
                   group_size, torch.int32, k // 8)
    if k % _BK or group_size % _BK:
        raise NotImplementedError(
            f"w4a16 kernel needs K and group_size multiples of {_BK}, got "
            f"K={k}, group_size={group_size}")
    e, m, _ = x.shape
    y = torch.empty((e, m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0 or e == 0:
        return y
    bm, splits, per = int4b_plan(m, n, k, e)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.ct_w4a16_matmul_experts(
            x.data_ptr(), w_packed.data_ptr(), scales.data_ptr(),
            zp.data_ptr() if zp is not None else None, y.data_ptr(),
            e, m, n, k, group_size, bm, splits, per,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "w4a16_experts_matmul")
    w4a16_experts_matmul.launches += 1
    return y


w4a16_experts_matmul.launches = 0


def w4a16_a8b_experts_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                             scales: torch.Tensor, zp: torch.Tensor | None,
                             *, n: int, k: int, group_size: int,
                             xq: torch.Tensor | None = None,
                             xs: torch.Tensor | None = None) -> torch.Tensor:
    """Mode ``a8b`` of ``w4a16_experts_matmul``: the row pass quantizes all
    E * C rows to int8, then one GEMM launch covers every expert.

    :param xq: optional (E, C, K) int8 buffer for the quantized rows
    :param xs: optional (E, C) f32 buffer for their scales
    """
    if x.device.type == "cpu":
        return w4a16_matmul_plain(x, w_packed, scales, zp, n=n, k=k,
                                  group_size=group_size, mode="a8b")
    _check_experts("w4a16_a8b_experts_matmul", x, w_packed, scales, zp, n, k,
                   group_size, torch.int32, k // 8)
    if k % _BK or group_size % _BK:
        raise NotImplementedError(
            f"a8b kernel needs K and group_size multiples of {_BK}, got "
            f"K={k}, group_size={group_size}")
    e, m, _ = x.shape
    y = torch.empty((e, m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0 or e == 0:
        return y
    if xq is None:
        xq = torch.empty((e, m, k), dtype=torch.int8, device=x.device)
    if xs is None:
        xs = torch.empty((e, m), dtype=torch.float32, device=x.device)
    if (xq.dtype != torch.int8 or tuple(xq.shape) != (e, m, k)
            or xs.dtype != torch.float32 or tuple(xs.shape) != (e, m)
            or not (xq.is_contiguous() and xs.is_contiguous())
            or xq.device != x.device or xs.device != x.device
            or xq.data_ptr() % 16):
        raise ValueError("a8b scratch must be (E, C, K) int8 (16-byte "
                         "aligned) and (E, C) f32, contiguous on x's device")
    splits, per = a8b_plan(m, n, k, e)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.ct_w4a16_a8b_matmul_experts(
            x.data_ptr(), w_packed.data_ptr(), scales.data_ptr(),
            zp.data_ptr() if zp is not None else None, y.data_ptr(),
            xq.data_ptr(), xs.data_ptr(), e, m, n, k, group_size, splits,
            per, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "w4a16_a8b_experts_matmul")
    w4a16_a8b_experts_matmul.launches += 1
    return y


w4a16_a8b_experts_matmul.launches = 0


def w4_e8_experts_matmul(x: torch.Tensor, w8: torch.Tensor,
                         scales: torch.Tensor, *, n: int, k: int,
                         group_size: int) -> torch.Tensor:
    """y (E, C, N), y[e] = x[e] @ W[e]^T for every expert in one launch of
    the grouped-int8 kernel: x (E, C, K), W (E, N, K) signed int8 q - zp
    with (E, K/g, N) f32 scales. The design and split come from C rows and
    all E experts' blocks (``wna16_plan``)."""
    if x.device.type == "cpu":
        return w4_e8_matmul_plain(x, w8, scales, n=n, k=k,
                                  group_size=group_size)
    _check_experts("w4_e8_experts_matmul", x, w8, scales, None, n, k,
                   group_size, torch.int8, k)
    if group_size % 16 or k % 16:
        raise NotImplementedError(
            f"w4_e8_experts_matmul needs a group size and K that are "
            f"multiples of 16; got K={k}, group_size={group_size}")
    e, m, _ = x.shape
    if m * k >= 2**31 or n * k >= 2**31:
        raise NotImplementedError("w4_e8_experts_matmul indexes one expert's "
                                  "x and weight with 32-bit offsets: C*K and "
                                  "N*K must stay below 2^31")
    y = torch.empty((e, m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0 or e == 0:
        return y
    bm, splits, tiles_per_split = wna16_plan(m, n, k, e)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.ct_w4_e8_matmul_experts(
            x.data_ptr(), w8.data_ptr(), scales.data_ptr(), y.data_ptr(),
            e, m, n, k, group_size, bm, splits, tiles_per_split,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "w4_e8_experts_matmul")
    w4_e8_experts_matmul.launches += 1
    return y


w4_e8_experts_matmul.launches = 0


# ---- the int32 8-plane layout (w4_layout="packed") --------------------- #

PLANES = 8  # nibbles per int32 word: one quant group each per k-tile
PLANE_MODES = ("int4", "a8", "mat")


def choose_k_tile(k: int, group_size: int) -> int:
    """TK = 8 * group_size: one quant group per nibble plane."""
    return PLANES * group_size


def padded_k(k: int, group_size: int) -> int:
    """K rounded up to a multiple of the k-tile."""
    tk = choose_k_tile(k, group_size)
    return -(-k // tk) * tk


def retile_groups(scales_t: torch.Tensor, k: int, tk: int,
                  group_size: int) -> torch.Tensor:
    """(K_pad/g, N) scales or zero points as the kernel reads them: tile
    t's rows are its 8 groups, which the (K_pad/g, N) order already is.
    K must already be padded to a multiple of ``tk``."""
    if scales_t.shape[0] != (k // tk) * PLANES:
        raise ValueError(f"expected {(k // tk) * PLANES} group rows for "
                         f"K={k}, got {scales_t.shape[0]}")
    return scales_t


def repack_w4_for_kernel(unpacked_u: torch.Tensor, num_bits: int, k: int,
                         tk: int) -> torch.Tensor:
    """Offset codes u = q + 8 (N, K) in [0, 15] -> the (K/8, N) int32 plane
    layout; K must already be padded to a multiple of ``tk``."""
    if num_bits != 4:
        raise ValueError(f"the plane layout holds 4-bit codes, got "
                         f"{num_bits} bits")
    n = unpacked_u.shape[0]
    v = unpacked_u.t().to(torch.int64).reshape(k // tk, PLANES,
                                               tk // PLANES, n)
    shifts = 4 * torch.arange(PLANES, dtype=torch.int64,
                              device=v.device).reshape(1, PLANES, 1, 1)
    words = (v << shifts).sum(dim=1)  # (T, g, N) in [0, 2^32)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32).reshape(k // 8, n)


def _plane_codes(words: torch.Tensor, group_size: int) -> torch.Tensor:
    """(K/8, N) int32 plane words -> (K, N) int32 offset codes u, in k
    order."""
    rows, n = words.shape
    w = words.reshape(rows // group_size, 1, group_size, n)
    shifts = 4 * torch.arange(PLANES, dtype=torch.int32,
                              device=words.device).reshape(1, PLANES, 1, 1)
    return ((w >> shifts) & 0xF).reshape(rows * 8, n)


def w4a16_planes_matmul_plain(x, words, scales, zp, *, n, k, group_size,
                              mode="int4", out_dtype=None):
    """Plain version of the plane modes, in the kernel's form, accumulated
    in f32 and cast once to ``out_dtype`` (x's dtype by default). ``k`` is
    K_pad; x (M, K_orig) is zero-padded to it. Modes int4 and a8 fold the
    offset into the codes (u - 8 - zp, exact for the integer zero points
    of a checkpoint) where the TPU kernel subtracts it afterwards as a
    rank-8 correction: the same sum, with no cancellation of two large
    terms. Mode mat keeps the TPU kernel's bf16(u * s) tile and its
    correction."""
    if mode not in PLANE_MODES:
        raise ValueError(f"unknown plane mode {mode!r}")
    g, groups = group_size, k // group_size
    m = x.shape[0]
    compute = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    if mode == "a8":
        xq, x_scale = quantize_rows_a8b_plain(x)
        xf = xq.to(torch.float32)  # exact int8 values
    else:
        xf = x.to(compute).to(torch.float32)
    xg = F.pad(xf, (0, k - x.shape[1])).reshape(m, groups, g)
    u = _plane_codes(words, g).to(torch.float32).reshape(groups, g, n)
    s = scales.to(torch.float32)
    off = 8.0 + zp.to(torch.float32) if zp is not None else 8.0
    if mode == "mat":
        corr = xg.sum(dim=-1) @ (off * s)  # the rank-8 correction
        w = (u * s[:, None, :]).to(compute).to(torch.float32)
        y = xg.reshape(m, k) @ w.reshape(k, n) - corr
    else:
        # the offset folded into the codes: u - (8 + zp), exact integers
        v = u - (off[:, None, :] if zp is not None else off)
        part = torch.einsum("mgr,grn->mgn", xg, v)  # exact for int8 x
        y = (part * s).sum(dim=1)
        if mode == "a8":
            y = y * x_scale[:, None]
    return y.to(out_dtype or x.dtype)


def w4a16_planes_matmul(x: torch.Tensor, words: torch.Tensor,
                        scales: torch.Tensor, zp: torch.Tensor | None, *,
                        n: int, k: int, group_size: int, mode: str = "int4",
                        xq: torch.Tensor | None = None,
                        xs: torch.Tensor | None = None) -> torch.Tensor:
    """y (M, N) = x (M, K_orig) @ W^T for W in the int32 plane layout:
    (k/8, N) int32 words, k = K_pad >= K_orig, and (k/g, N) f32 scales and
    optional zero points. ``mode`` is "int4", "a8" or "mat"; each counts
    its launches on ``<mode>_launches``.

    :param xq: mode a8 only: optional (M, K_orig) int8 buffer for the
        kernel's quantized rows
    :param xs: mode a8 only: optional (M,) f32 buffer for their scales
    """
    if x.device.type == "cpu":
        return w4a16_planes_matmul_plain(x, words, scales, zp, n=n, k=k,
                                         group_size=group_size, mode=mode)
    if mode not in PLANE_MODES:
        raise ValueError(f"unknown plane mode {mode!r}")
    if x.dtype != torch.bfloat16 or x.dim() != 2:
        raise ValueError(f"x must be (M, K) bf16, got {tuple(x.shape)} "
                         f"{x.dtype}")
    m, kx = x.shape
    tk = choose_k_tile(k, group_size)
    if (group_size % 32 or group_size > 128 or k % tk or kx > k or kx % 16
            or n % 4):
        raise NotImplementedError(
            f"w4a16_planes_matmul needs a group size that is a multiple of "
            f"32 up to 128, K_pad a multiple of 8 groups, K <= K_pad with K "
            f"a multiple of 16, and N a multiple of 4; got K={kx}, "
            f"K_pad={k}, N={n}, group_size={group_size}")
    if (words.dtype != torch.int32 or tuple(words.shape) != (k // 8, n)
            or scales.dtype != torch.float32
            or tuple(scales.shape) != (k // group_size, n)
            or (zp is not None and (zp.dtype != torch.float32
                                    or zp.shape != scales.shape))):
        raise ValueError(f"w4a16_planes_matmul: words must be ({k // 8}, "
                         f"{n}) int32, scales and zero points "
                         f"({k // group_size}, {n}) f32")
    tensors = [x, words, scales] + ([zp] if zp is not None else [])
    if any(t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16
           for t in tensors):
        raise ValueError("w4a16_planes_matmul operands must be contiguous, "
                         "16-byte aligned and on one device")
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    unit = tk // _BK
    splits, tiles_per_split = _split_k(m, n, k, unit,
                                       tile_m=128 if m > 64 else 64,
                                       tile_n=128)
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    common = (y.data_ptr(),
              partial.data_ptr() if partial is not None else None)
    sizes = (m, n, kx, k, group_size, splits, tiles_per_split // unit)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        operands = (x.data_ptr(), words.data_ptr(), scales.data_ptr(),
                    zp.data_ptr() if zp is not None else None)
        if mode == "a8":
            if xq is None:
                xq = torch.empty((m, kx), dtype=torch.int8, device=x.device)
            if xs is None:
                xs = torch.empty((m,), dtype=torch.float32, device=x.device)
            if (xq.dtype != torch.int8 or tuple(xq.shape) != (m, kx)
                    or xs.dtype != torch.float32 or tuple(xs.shape) != (m,)
                    or not (xq.is_contiguous() and xs.is_contiguous())
                    or xq.device != x.device or xs.device != x.device):
                raise ValueError("a8 scratch must be (M, K) int8 and (M,) "
                                 "f32, contiguous on x's device")
            err = lib.ct_w4a16_planes_a8(*operands, *common, xq.data_ptr(),
                                         xs.data_ptr(), *sizes, stream)
        else:
            err = getattr(lib, f"ct_w4a16_planes_{mode}")(
                *operands, *common, *sizes, stream)
    _build.check(err, f"w4a16_planes_matmul[{mode}]")
    counter = f"{mode}_launches"
    setattr(w4a16_planes_matmul, counter,
            getattr(w4a16_planes_matmul, counter) + 1)
    return y


w4a16_planes_matmul.int4_launches = 0
w4a16_planes_matmul.a8_launches = 0
w4a16_planes_matmul.mat_launches = 0
