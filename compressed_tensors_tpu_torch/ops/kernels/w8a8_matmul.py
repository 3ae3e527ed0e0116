"""W8A8 matmul with dynamic per-token activation quantization (int8 or
fp8 e4m3).

Replaces ``compressed_tensors_tpu/ops/kernels/w8a8_matmul.py:w8a8_matmul``
with the hand-written Hopper kernels in ``csrc/w8a8_matmul.cu``: a row
pass quantizes x per token exactly as the TPU kernel (int8: scale =
max(absmax / 127.5, 1e-10), q = round(clip(x / scale, -128, 127)); fp8:
scale = max(absmax / 448, 1e-10), q = e4m3(clip(x / scale, -448, 448))),
then a GEMM on ``wgmma`` (int8 with exact int32 sums, or e4m3 with f32
sums) writes acc * x_scale * w_scale once in bf16. ``w8a8_plan`` picks the
design: y^T = W x^T over 128-weight-row blocks at decode rows (M <= 64),
with K split over a thread-block cluster when the column tiles leave SMs
idle; 128 x 256 output tiles at prefill rows.

Weight layout: the checkpoint's (N, K) int8 or fp8 rows (K-major per
output channel, the kernel's operand as is) and a (N,) f32 per-channel
scale. K must be a multiple of 16.

Bound on the H100: the N*K weight bytes at decode rows (M = 64); the 8-bit
tensor-core operations at a 512-row prefill chunk.

``w8a8_matmul`` launches the kernel for CUDA tensors and uses
``w8a8_matmul_plain`` only for CPU tensors. Launches with int8 weights
count in ``w8a8_matmul.launches``, with fp8 weights in
``w8a8_matmul.fp8_launches``.
"""

from __future__ import annotations

import torch

from compressed_tensors_tpu_torch.ops.kernels import _build

__all__ = ["w8a8_matmul", "w8a8_matmul_plain", "quantize_rows_plain",
           "w8a8_plan", "check_w8a8_operands"]

_K_ALIGN = 16          # K bytes a 16-byte copy: rows stay aligned
_BK = 128              # k values a k-tile
_DECODE_ROWS = 64      # M <= 64: y^T = W x^T over weight-row blocks
_BW = 128              # weight rows a decode block
_PREFILL_BN = 256      # output columns a prefill tile (PBN in the source)
_SMS = 132             # H100 SXM


def quantize_rows_plain(x, w_dtype):
    """The kernel's row pass in plain PyTorch: (xq (..., K) in
    ``w_dtype``, x_scale (...) f32)."""
    xf = x.to(torch.float32)
    is_int8 = w_dtype == torch.int8
    q_max = 127.0 if is_int8 else 448.0
    half_range = (2 * q_max + 1) / 2 if is_int8 else q_max
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, which is not the IEEE division the kernel does
    x_scale = torch.clamp(absmax / torch.full_like(absmax, half_range),
                          min=1e-10)
    scaled = xf / x_scale
    if is_int8:
        xq = torch.round(scaled.clamp(-q_max - 1, q_max)).to(torch.int8)
    else:
        xq = scaled.clamp(-q_max, q_max).to(w_dtype)
    return xq, x_scale.squeeze(-1)


def w8a8_matmul_plain(x, w, w_scale, *, n, k, out_dtype=None):
    """Plain PyTorch version of the same arithmetic. The 8-bit product is
    summed in f64, which is exact at these magnitudes (the kernel sums
    int8 exactly in int32, e4m3 in f32); ``out_dtype`` defaults to x's."""
    xq, x_scale = quantize_rows_plain(x, w.dtype)
    acc = (xq.to(torch.float32).to(torch.float64)
           @ w.to(torch.float32).to(torch.float64).t()).to(torch.float32)
    return (acc * x_scale[..., None] * w_scale.to(torch.float32).reshape(1, -1)
            ).to(out_dtype or x.dtype)


def w8a8_plan(m: int, n: int, k: int) -> tuple[int, int, int]:
    """(rows a block, K splits, k-tiles a split) of the GEMM, as
    ``tools/w8a8_sweep.py`` measured fastest at the 8B linears on the H100.
    Decode rows take a block of 16, 32 or 64 rows (the fewest that hold M)
    by 128 weight rows, two blocks an SM, and split K over a cluster of up
    to 4 blocks as far as two blocks an SM allow. Prefill rows take 128 x
    256 tiles, one block an SM, and the split with the least estimated
    time, the number of waves of blocks times a block's k-tiles plus 4 for
    its pipeline's fill and its epilogue (the fewer splits on a tie). The
    split is then as many blocks as its k-tiles per block leave none
    empty."""
    tiles = -(-k // _BK)
    if m <= _DECODE_ROWS:
        bm = next(b for b in (16, 32, 64) if m <= b)
        blocks = -(-n // _BW)
        split = max(s for s in (1, 2, 4)
                    if s == 1 or (s <= tiles and blocks * s <= 2 * _SMS))
    else:
        bm = 128
        blocks = -(-n // _PREFILL_BN) * -(-m // bm)

        def cost(s):
            return -(-blocks * s // _SMS) * (-(-tiles // s) + 4)

        split = min((s for s in (1, 2, 4, 8) if s <= tiles), key=cost)
    per = -(-tiles // split)
    return bm, -(-tiles // per), per


def check_w8a8_operands(x, w, w_scale, xq, xs, *, n: int, k: int) -> None:
    """Raise unless the kernel can take these operands: bf16 x (M, K),
    int8 or e4m3 W (N, K) with K a multiple of 16, a (N,) f32 scale,
    scratch xq (M, K) in W's dtype and xs (M,) f32, all contiguous on one
    device, and x, W, the scale and xq 16-byte aligned (the kernels move
    them 16 bytes a copy)."""
    if w.dtype not in (torch.int8, torch.float8_e4m3fn):
        raise NotImplementedError(f"w8a8 kernel for {w.dtype} weights")
    m = x.shape[0]
    if x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"x must be (M, {k}) bf16, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if k % _K_ALIGN:
        raise NotImplementedError(f"w8a8 kernel needs K % {_K_ALIGN} == 0, "
                                  f"got {k}")
    if (tuple(w.shape) != (n, k) or w_scale.dtype != torch.float32
            or w_scale.numel() != n):
        raise ValueError("w8a8 kernel layout mismatch")
    if (xq.dtype != w.dtype or tuple(xq.shape) != (m, k)
            or xs.dtype != torch.float32 or xs.numel() != m):
        raise ValueError("w8a8 scratch mismatch")
    if any(t.device != x.device or not t.is_contiguous()
           for t in (x, w, w_scale, xq, xs)):
        raise ValueError("w8a8 operands must be contiguous on one device")
    if any(t.data_ptr() % 16 for t in (x, w, w_scale, xq)):
        raise ValueError("w8a8 operands x, w, w_scale and xq must be "
                         "16-byte aligned")


def w8a8_matmul(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor, *,
                n: int, k: int, xq: torch.Tensor | None = None,
                xs: torch.Tensor | None = None) -> torch.Tensor:
    """y (M, N) = dynamic_quant(x) @ W^T rescaled, for W (N, K) int8 or fp8
    e4m3 and a (N,) f32 per-channel scale. ``xq`` (M, K) in W's dtype and
    ``xs`` (M,) f32 optionally take the kernel's quantized rows and scales
    (scratch otherwise)."""
    if x.device.type == "cpu":
        return w8a8_matmul_plain(x, w, w_scale, n=n, k=k)
    fp8 = w.dtype == torch.float8_e4m3fn
    m = x.shape[0]
    if xq is None:
        xq = torch.empty((m, k), dtype=w.dtype, device=x.device)
    if xs is None:
        xs = torch.empty((m,), dtype=torch.float32, device=x.device)
    check_w8a8_operands(x, w, w_scale, xq, xs, n=n, k=k)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    bm, splits, per = w8a8_plan(m, n, k)
    lib = _build.load()
    fn = lib.ct_w8a8_fp8_matmul if fp8 else lib.ct_w8a8_matmul
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), w_scale.data_ptr(), y.data_ptr(),
                 xq.data_ptr(), xs.data_ptr(), m, n, k, bm, splits, per,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "w8a8_matmul")
    if fp8:
        w8a8_matmul.fp8_launches += 1
    else:
        w8a8_matmul.launches += 1
    return y


w8a8_matmul.launches = 0
w8a8_matmul.fp8_launches = 0
