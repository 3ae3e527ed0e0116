#!/usr/bin/env python3
"""Host time of one kernel call of the port on one GPU.

    python3 tools/host_launch_probe.py [--root DIR] [--calls 200]

Times, on the host's clock, how long one call of a wrapper takes to
return (its checks, scratch allocations, the ctypes call and its kernel
launches; no synchronization) at Llama-3-8B's decode shapes: flash and
paged decode attention (batch 64, 32 over 8 heads of 128, lengths
0-1000 in a 1024-position slab or 64-position pages) on a bf16 and an fp8
cache, and the fp8 W8A8 and the W4A16 (``int4b``, g128) matmuls of the
fused qkv linear at 64 rows.
Each reading is ``--calls`` calls back to back after a warm-up call,
divided by their number, the median and the least of 7 repeats. The
device runs behind: the queue holds every call's launches, so the host
never waits. ``--root`` times another checkout of the repository (its
own package and kernel build), so two trees compare in one process each
on the same card. One JSON line last.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("host_launch_probe: no CUDA device", file=sys.stderr)
        return 2
    from compressed_tensors_tpu_torch.ops.kernels import (
        flash_decode as fd,
        paged_decode as pd,
        w4a16_matmul as w4,
        w8a8_matmul as w8,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, "root:", os.path.abspath(args.root), flush=True)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, H, KVH, D, S, page, layers = 64, 32, 8, 128, 1024, 64, 2
    per_row = S // page

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    q, nk, nv = randn(B, H, D), randn(B, KVH, D), randn(B, KVH, D)
    lengths = torch.from_numpy(rng.integers(0, 1001, B).astype(np.int32)).cuda()
    pages = rng.permutation(B * per_row).astype(np.int32) + 1
    tables = torch.from_numpy(pages.reshape(B, per_row)).cuda()
    scale = torch.full((1,), 0.03, dtype=torch.float32, device="cuda")

    def caches(shape, dtype):
        c = (randn(*shape) * 4).to(dtype)
        return c, c.clone()

    calls = {}
    for kind, dtype in (("bf16", torch.bfloat16),
                        ("fp8", torch.float8_e4m3fn)):
        sc = {} if kind == "bf16" else dict(k_scale=scale, v_scale=scale)
        ck, cv = caches((layers, B, KVH, S, D), dtype)
        pk, pv = caches((layers, B * per_row + 1, KVH, page, D), dtype)
        calls[f"flash_decode_attention {kind}"] = (
            lambda ck=ck, cv=cv, sc=sc: fd.flash_decode_attention(
                q, nk, nv, ck, cv, lengths, layer=1, **sc))
        calls[f"paged_decode_attention {kind}"] = (
            lambda pk=pk, pv=pv, sc=sc: pd.paged_decode_attention(
                q, nk, nv, pk, pv, tables, lengths, layer=1, **sc))
    n, k = 6144, 4096
    w = (randn(n, k) * 64).to(torch.float8_e4m3fn)
    ws = torch.full((n,), 1e-3, dtype=torch.float32, device="cuda")
    x = randn(64, k)
    calls["w8a8_matmul fp8 qkv M=64"] = lambda: w8.w8a8_matmul(
        x, w, ws, n=n, k=k)
    words = torch.randint(-(2**31), 2**31, (n, k // 8), generator=gen,
                          device="cuda", dtype=torch.int64).to(torch.int32)
    s4 = torch.full((k // 128, n), 1e-3, dtype=torch.float32, device="cuda")
    calls["w4a16_matmul int4b qkv M=64"] = lambda: w4.w4a16_matmul(
        x, words, s4, None, n=n, k=k, group_size=128)

    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        reps = []
        for _ in range(7):
            t0 = time.perf_counter()
            for _ in range(args.calls):
                fn()
            reps.append((time.perf_counter() - t0) / args.calls * 1e6)
            torch.cuda.synchronize()
        out[name] = dict(median_us=statistics.median(reps), min_us=min(reps))
        print(f"{name}: {out[name]['median_us']:.2f} us a call (median of 7"
              f", least {out[name]['min_us']:.2f})", flush=True)
    print(json.dumps({"device": smi, "root": os.path.abspath(args.root),
                      "host_us": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
