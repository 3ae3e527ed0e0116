"""W8A8 matmul with dynamic per-token activation quantization (int8 or
fp8 e4m3).

Replaces ``compressed_tensors_tpu/ops/kernels/w8a8_matmul.py:w8a8_matmul``
with the hand-written Hopper kernels in ``csrc/w8a8_matmul.cu``: a row
pass quantizes x per token exactly as the TPU kernel (int8: scale =
max(absmax / 127.5, 1e-10), q = round(clip(x / scale, -128, 127)); fp8:
scale = max(absmax / 448, 1e-10), q = e4m3(clip(x / scale, -448, 448))),
then a tensor-core GEMM (int8 with exact int32 sums, or e4m3 with f32
sums) writes acc * x_scale * w_scale once in bf16.

Weight layout: the checkpoint's (N, K) int8 or fp8 rows (K-major per
output channel, the kernel's B operand as is) and a (N,) f32 per-channel
scale.

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

__all__ = ["w8a8_matmul", "w8a8_matmul_plain", "quantize_rows_plain"]

_BK = 64


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
    if w.dtype != torch.int8 and not fp8:
        raise NotImplementedError(f"w8a8 kernel for {w.dtype} weights")
    m = x.shape[0]
    if x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"x must be (M, {k}) bf16, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if k % _BK:
        raise NotImplementedError(f"w8a8 kernel needs K % {_BK} == 0, got {k}")
    if (tuple(w.shape) != (n, k) or w_scale.dtype != torch.float32
            or w_scale.numel() != n):
        raise ValueError("w8a8 kernel layout mismatch")
    if xq is None:
        xq = torch.empty((m, k), dtype=w.dtype, device=x.device)
    if xs is None:
        xs = torch.empty((m,), dtype=torch.float32, device=x.device)
    if (xq.dtype != w.dtype or tuple(xq.shape) != (m, k)
            or xs.dtype != torch.float32 or xs.numel() != m):
        raise ValueError("w8a8 scratch mismatch")
    if any(t.device != x.device or not t.is_contiguous()
           for t in (x, w, w_scale, xq, xs)):
        raise ValueError("w8a8 operands must be contiguous on one device")
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    lib = _build.load()
    fn = lib.ct_w8a8_fp8_matmul if fp8 else lib.ct_w8a8_matmul
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), w_scale.data_ptr(), y.data_ptr(),
                 xq.data_ptr(), xs.data_ptr(), m, n, k,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "w8a8_matmul")
    if fp8:
        w8a8_matmul.fp8_launches += 1
    else:
        w8a8_matmul.launches += 1
    return y


w8a8_matmul.launches = 0
w8a8_matmul.fp8_launches = 0
