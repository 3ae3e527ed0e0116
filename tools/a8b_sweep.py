#!/usr/bin/env python3
"""Design sweep of the a8b W4A16 kernel (B2, ``csrc/w4a16_matmul.cu``) on
one GPU.

    python3 tools/a8b_sweep.py [--rows 256 512] [--out sweep.json]

For each row count and each of the four fused linears of one Llama-3-8B
layer (W4A16 g128): the device ms of the row
quantization pass alone and of the GEMM at every K split (1, 2, 4, 8
blocks of a cluster), each output held to the a8b rule against the plain
version, beside the split ``a8b_plan`` picks, and ``torch.matmul`` on the
dequantized bf16 weight. Timing as ``chip_smoke.py``'s: CUDA-graph replays
over copies of the weight larger than L2. Prints ptxas's registers and
spills of the a8b kernels first, and one JSON line last; with
``--out`` also writes every row to that JSON file.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("a8b_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from compressed_tensors_tpu_torch.ops.kernels import _build
    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, nargs="+", default=[256, 512])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    _build.build(verbose=False)
    lib = _build.load()
    for name, (regs, spill) in sorted(_build.ptxas_report(
            ("w4a16_matmul.cu",)).items()):
        if "w4a8" in name:
            print(f"resources {name}: {regs} registers, {spill} bytes "
                  "spilled", flush=True)
    rng = np.random.default_rng(5)
    for m in args.rows:
        for lin, (n, k) in cs.W4_SHAPES_8B.items():
            x, w, s, _ = cs.w4_inputs(rng, n, k, m, torch.device("cuda"))
            want = w4.w4a16_matmul_plain(x, w, s, None, n=n, k=k,
                                         group_size=128, mode="a8b",
                                         out_dtype=torch.float32)
            ws = [w.clone() for _ in range(cs.copies_for(n * k // 2))]
            tq, _ = cs.a8b_parts_ms(x, ws[:1], s, n, k)
            xq, xs = w4.quantize_rows_a8b_plain(x)
            y = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
            tiles = -(-k // 128)
            picked, _ = w4.a8b_plan(m, n, k)

            def run(ww, splits):
                per = -(-tiles // splits)
                _build.check(lib.ct_w4a16_a8b_gemm(
                    xq.data_ptr(), xs.data_ptr(), ww.data_ptr(),
                    s.data_ptr(), None, y.data_ptr(), m, n, k, 128,
                    -(-tiles // per), per,
                    torch.cuda.current_stream().cuda_stream), "a8b gemm")

            times = {}
            for splits in (1, 2, 4, 8):
                if splits > tiles:
                    continue
                run(w, splits)
                torch.cuda.synchronize()
                bad = int(((y.float() - want).abs() > cs.A8B_REL
                           * want.abs() + cs.A8B_ABS
                           * want.abs().max()).sum())
                if bad:
                    raise AssertionError(
                        f"a8b {lin} M={m} splits={splits}: "
                        f"{bad} elements outside the a8b rule")
                times[splits] = cs.device_ms(
                    [lambda ww=ww, sp=splits: run(ww, sp) for ww in ws])
            del ws
            wd = w4._dequantized_weight(w, s, None, n, k, 128).to(
                torch.bfloat16)
            wds = [wd.clone() for _ in range(cs.copies_for(wd.numel() * 2))]
            lib_ms = cs.device_ms([lambda wd=wd: torch.matmul(x, wd.t())
                                   for wd in wds])
            del wds, wd, want
            torch.cuda.empty_cache()
            rows.append(dict(linear=lin, m=m, n=n, k=k,
                             picked=picked, quantize_ms=tq, gemm_ms=times,
                             library_ms=lib_ms))
            print(f"a8b {lin} M={m}: quantize "
                  f"{tq:.4f} ms; GEMM "
                  + ", ".join(f"splits {sp}: {t:.4f}"
                              for sp, t in times.items())
                  + f" ms; plan {picked}; torch.matmul {lib_ms:.4f} ms",
                  flush=True)
        sel = [r for r in rows if r["m"] == m]
        print(f"a8b layer M={m}: quantize "
              f"{sum(r['quantize_ms'] for r in sel):.4f} + GEMM at the "
              f"plan {sum(r['gemm_ms'][r['picked']] for r in sel):.4f} "
              f"ms (best split "
              f"{sum(min(r['gemm_ms'].values()) for r in sel):.4f}); "
              f"torch.matmul {sum(r['library_ms'] for r in sel):.4f} ms",
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, rows=rows), f, indent=1)
    print(json.dumps({"device": smi, "rows": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
