#!/usr/bin/env python3
"""Split sweep of the W8A8 GEMM (B3, ``csrc/w8a8_matmul.cu``) on one GPU.

    python3 tools/w8a8_sweep.py [--rows 64 512] [--out sweep.json]

For int8 and fp8 e4m3 weights, each of the four fused linears of one
Llama-3-8B layer (qkv, o, gate_up, down) and, for int8 at decode rows, the
8B lm_head: the device ms of the GEMM pass alone (on rows quantized
beforehand) at every K split, each output held against the plain version
by the a8b rule (elements outside 2^-8 |y| + 1e-4 max|y|, and the worst
share of that allowance), beside the split ``w8a8_plan`` picks, the
row-quantize pass alone, and ``torch._scaled_mm`` / ``torch._int_mm`` on
the same quantized rows. Timing as ``chip_smoke.py``'s: CUDA-graph
replays over copies of the weight larger than L2. One JSON line last; with ``--out`` also a file.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("w8a8_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from compressed_tensors_tpu_torch.ops.kernels import _build
    from compressed_tensors_tpu_torch.ops.kernels import w8a8_matmul as w8

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, nargs="+", default=[64, 512])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(verbose=False)
    lib = _build.load()
    for name, (regs, spill) in sorted(_build.ptxas_report(
            ("w8a8_matmul.cu",)).items()):
        print(f"resources {name}: {regs} registers, {spill} bytes spilled",
              flush=True)
    gen = torch.Generator(device="cuda").manual_seed(7)

    def stream():  # the capturing stream while device_ms records a graph
        return torch.cuda.current_stream().cuda_stream

    rows = []
    for fp8 in (True, False):
        kind = "fp8" if fp8 else "int8"
        shapes = dict(cs.W4_SHAPES_8B)
        if not fp8:
            shapes["lm_head"] = (cs.VOCAB8, 4096)
        for m in args.rows:
            for lin, (n, k) in shapes.items():
                if lin == "lm_head" and m > 64:
                    continue
                if fp8:
                    w, s = cs.fp8_weight(gen, n, k)
                else:
                    w = torch.randint(-127, 128, (n, k), generator=gen,
                                      device="cuda", dtype=torch.int8)
                    s = torch.rand((n,), generator=gen, device="cuda") \
                        * 2e-4 + 1e-4
                x = cs.dev_randn(gen, m, k)
                xq, xs = w8.quantize_rows_plain(x, w.dtype)
                want = w8.w8a8_matmul_plain(x, w, s, n=n, k=k,
                                            out_dtype=torch.float32)
                slack = 2**-8 * want.abs() + 1e-4 * want.abs().max()
                ws = [w.clone() for _ in range(cs.copies_for(n * k))]
                y = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
                tiles = -(-k // 128)
                bm, picked, _ = w8.w8a8_plan(m, n, k)
                qt = cs.device_ms([lambda: lib.ct_w8a8_quantize(
                    x.data_ptr(), xq.data_ptr(), xs.data_ptr(), m, k,
                    int(fp8), stream())] * 8)
                xq, xs = w8.quantize_rows_plain(x, w.dtype)
                try:
                    if fp8:
                        tl = cs.device_ms([lambda w=w: torch._scaled_mm(
                            xq, w.t(), scale_a=xs[:, None],
                            scale_b=s[None, :], out_dtype=torch.bfloat16)
                            for w in ws])
                    else:
                        tl = cs.device_ms([lambda w=w: torch._int_mm(
                            xq, w.t()) for w in ws])
                except (RuntimeError, TypeError) as exc:
                    print(f"library call unavailable: {exc}", flush=True)
                    tl = None
                for sp in (1, 2, 4, 8):
                    if sp > tiles:
                        continue
                    per = -(-tiles // sp)
                    splits = -(-tiles // per)

                    def run(ww):
                        err = lib.ct_w8a8_gemm(
                            xq.data_ptr(), xs.data_ptr(), ww.data_ptr(),
                            s.data_ptr(), y.data_ptr(), m, n, k, int(fp8),
                            bm, splits, per, stream())
                        _build.check(err, "w8a8_gemm")

                    run(w)
                    torch.cuda.synchronize()
                    diff = (y.float() - want).abs()
                    outside = int((diff > slack).sum())
                    worst = (diff / slack).max().item()
                    t = cs.device_ms([lambda ww=ww: run(ww) for ww in ws])
                    row = dict(weight=kind, linear=lin, m=m, n=n, k=k, bm=bm,
                               splits=splits, per=per,
                               ms=t, quantize_ms=qt, library_ms=tl,
                               outside=outside, worst_share=worst,
                               picked=splits == picked)
                    rows.append(row)
                    print(f"{kind} {lin} M={m} bm={bm} splits={splits}: "
                          f"{t:.4f} ms (quantize {qt:.4f}, library {tl}) "
                          f"outside {outside}, worst {worst:.3f} of the "
                          f"allowance{' <- plan' if row['picked'] else ''}",
                          flush=True)
                del ws, w
                torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    print(json.dumps({"device": smi, "rows": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
