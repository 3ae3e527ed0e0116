"""The yardstick's arithmetic, frozen: the H100's published peaks, the
operations and bytes of the port's kernels worked from their call shapes,
the kernel names that say which kernel a device operation is, and the
model FLOPs behind ``mfu_pct``.

Bytes count each input read once and each output written once (what the
call needs, not what the kernel reads again); operations count the
multiply-adds as two. A kernel's bound is the larger of its operations at
the peak of its arithmetic and its bytes at HBM bandwidth.
"""

from __future__ import annotations

import re

# NVIDIA H100 SXM5 data sheet, dense (no sparsity), at 700 W
PEAK = {
    "bf16": 989e12,        # FLOP/s, tensor cores
    "int8": 1979e12,       # OP/s, tensor cores
    "fp8": 1979e12,        # FLOP/s, tensor cores
    "hbm": 3.35e12,        # bytes/s
}

# device operation name -> kernel: the port's CUDA kernels by the names
# their sources give them (csrc/*.cu), as the profiler reports them. B1's
# int4b prefill kernel is no template; B4's prefill_kernel<D> is.
KERNEL_NAMES = {
    "B1": (r"int4b::dec::decode_kernel", r"int4b::pre::prefill_kernel\("),
    "B2": (r"a8b::w4a8_kernel", r"quantize_rows_a8b_kernel"),
    "B4": (r"prefill_kernel<",),
    # paged_decode.cu's split_kernel<D, PAGED, KIND>: PAGED is B7, not
    # flash decode (B6) on the dense cache
    "B7": (r"split_kernel<\d+, true",),
}
# a kernel whose launch belongs to the operation launched just before it
# (paged_decode.cu's merge pass serves B6 and B7 alike)
FOLLOWERS = (r"merge_kernel<",)


def kernel_of(name: str, previous: str | None = None) -> str | None:
    """Which of ``KERNEL_NAMES`` a device operation is, or None;
    ``previous`` is the kernel of the operation before it on the stream."""
    for kernel, patterns in KERNEL_NAMES.items():
        if any(re.search(p, name) for p in patterns):
            return kernel
    if previous is not None and any(re.search(p, name) for p in FOLLOWERS):
        return previous
    return None


def bound_s(ops: float, nbytes: float, peak: str) -> float:
    """Least seconds a call can take on the H100."""
    return max(ops / PEAK[peak], nbytes / PEAK["hbm"])


def w4a16(m: int, n: int, k: int, group: int, act: str,
          zero_points: bool = False) -> tuple[float, float, str]:
    """B1 (bf16 activations, ``act="bf16"``) or B2 (rows quantized to int8,
    ``act="int8"``): y (M, N) bf16 = x (M, K) bf16 @ W^T, W as (N, K/8)
    int32 words with (K/g, N) f32 scales (and zero points). Returns (ops,
    bytes, peak)."""
    groups = k // group * n
    nbytes = (n * k // 2 + groups * 4 * (2 if zero_points else 1)
              + m * k * 2 + m * n * 2)
    return 2.0 * m * n * k, float(nbytes), "int8" if act == "int8" else "bf16"


def prefill_attention(b: int, s: int, h: int, kvh: int,
                      d: int) -> tuple[float, float, str]:
    """B4: causal attention of a fresh chunk, q/out (B, S, H, D), k/v (B,
    S, KVH, D), bf16. QK^T and PV over the causal half."""
    ops = 4.0 * b * h * (s * (s + 1) / 2) * d
    nbytes = 2.0 * b * s * d * (2 * h + 2 * kvh)
    return ops, nbytes, "bf16"


def paged_decode(lengths, h: int, kvh: int, d: int,
                 cache_bytes: int = 2) -> tuple[float, float, str]:
    """B7: one decode step over the paged pool for the active rows of
    ``lengths`` (each row's cached tokens before the step): q (H, D) and
    the new k/v (KVH, D) in, out (H, D) out, the new k/v written to the
    pool, and every cached K/V row of the row's live length read."""
    live = [int(n) for n in lengths if n >= 0]
    rows = len(live)
    cached = sum(live)
    ops = 4.0 * h * d * (cached + rows)
    nbytes = (2.0 * rows * d * (2 * h + 2 * kvh)            # q, out, new k/v
              + cache_bytes * rows * 2 * kvh * d            # k/v written
              + cache_bytes * cached * 2 * kvh * d)         # k/v read
    return ops, nbytes, "bf16"


def linear_params(cfg: dict) -> int:
    """Weights of one decoder layer's linears."""
    hid, inter = cfg["hidden_size"], cfg["intermediate_size"]
    d = cfg.get("head_dim") or hid // cfg["num_attention_heads"]
    q, kv = cfg["num_attention_heads"] * d, cfg["num_key_value_heads"] * d
    return hid * (q + 2 * kv) + q * hid + 3 * hid * inter


def model_flops(cfg: dict, tokens: int, attended: int, heads: int) -> float:
    """Model FLOPs of ``tokens`` positions through every layer, of
    ``attended`` (query, key) pairs summed over them (each position
    attends to itself and everything before it), and of ``heads`` lm_head
    rows."""
    d = cfg.get("head_dim") or cfg["hidden_size"] // cfg[
        "num_attention_heads"]
    layers = cfg["num_hidden_layers"]
    per_layer = (2.0 * linear_params(cfg) * tokens
                 + 4.0 * cfg["num_attention_heads"] * d * attended)
    return (layers * per_layer
            + 2.0 * cfg["vocab_size"] * cfg["hidden_size"] * heads)


def causal_pairs(start: int, length: int) -> int:
    """(query, key) pairs of ``length`` positions from ``start``: position
    p attends to p + 1 keys."""
    return length * start + length * (length + 1) // 2
