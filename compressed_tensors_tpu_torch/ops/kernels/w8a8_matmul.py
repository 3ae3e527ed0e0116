"""W8A8 matmul with dynamic per-token activation quantization (int8).

Replaces ``compressed_tensors_tpu/ops/kernels/w8a8_matmul.py:w8a8_matmul``
(int8 weights) with the hand-written Hopper kernel in
``csrc/w8a8_matmul.cu``: a row pass quantizes x per token exactly as the
TPU kernel (scale = max(absmax / 127.5, 1e-10), q = round(clip(x / scale,
-128, 127))), then an int8 tensor-core GEMM accumulates exactly in int32
and writes acc * x_scale * w_scale once in bf16.

Weight layout: the checkpoint's (N, K) int8 rows (K-major per output
channel, the kernel's B operand as is) and a (N,) f32 per-channel scale.

Bound on the H100: on this slice's path only the lm_head runs here, at
M = 64 rows, where the N*K weight bytes bound it.

``w8a8_matmul`` launches the kernel for CUDA tensors and uses
``w8a8_matmul_plain`` only for CPU tensors. The fp8 variant of the TPU
kernel has no CUDA kernel yet (ROADMAP B3, fp8).
"""

from __future__ import annotations

import torch

from compressed_tensors_tpu_torch.ops.kernels import _build

__all__ = ["w8a8_matmul", "w8a8_matmul_plain"]

_BK = 64


def w8a8_matmul_plain(x, w, w_scale, *, n, k):
    """Plain PyTorch version of the same arithmetic. The int8 product is
    summed in f64, which is exact at these magnitudes, like the kernel's
    int32 sums."""
    xf = x.to(torch.float32)
    is_int8 = w.dtype == torch.int8
    q_max = 127.0 if is_int8 else 448.0
    half_range = (2 * q_max + 1) / 2 if is_int8 else q_max
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, which is not the IEEE division the kernel does
    x_scale = torch.clamp(absmax / torch.full_like(absmax, half_range),
                          min=1e-10)
    scaled = xf / x_scale
    if is_int8:
        xq = torch.round(scaled.clamp(-q_max - 1, q_max))
    else:
        xq = scaled.clamp(-q_max, q_max).to(w.dtype).to(torch.float32)
    acc = (xq.to(torch.float64) @ w.to(torch.float64).t()).to(torch.float32)
    return (acc * x_scale * w_scale.to(torch.float32).reshape(1, -1)).to(
        x.dtype)


def w8a8_matmul(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor, *,
                n: int, k: int) -> torch.Tensor:
    """y (M, N) = dynamic_quant(x) @ W^T rescaled, for W (N, K) int8 (or
    fp8 on the CPU) and a (N,) f32 per-channel scale."""
    if x.device.type == "cpu":
        return w8a8_matmul_plain(x, w, w_scale, n=n, k=k)
    if w.dtype != torch.int8:
        raise NotImplementedError(
            "w8a8_matmul with fp8 weights has no CUDA kernel yet "
            "(ROADMAP B3, fp8 variant)")
    m = x.shape[0]
    if x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"x must be (M, {k}) bf16, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if k % _BK:
        raise NotImplementedError(f"w8a8 kernel needs K % {_BK} == 0, got {k}")
    if (tuple(w.shape) != (n, k) or w_scale.dtype != torch.float32
            or w_scale.numel() != n):
        raise ValueError("w8a8 kernel layout mismatch")
    if any(t.device != x.device or not t.is_contiguous()
           for t in (x, w, w_scale)):
        raise ValueError("w8a8 operands must be contiguous on one device")
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((m,), dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.ct_w8a8_matmul(
            x.data_ptr(), w.data_ptr(), w_scale.data_ptr(), y.data_ptr(),
            xq.data_ptr(), xs.data_ptr(), m, n, k,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "w8a8_matmul")
    w8a8_matmul.launches += 1
    return y


w8a8_matmul.launches = 0
