#!/usr/bin/env python3
"""Split sweep of the grouped-weight kernels (B8 fp4, B9 int8) on one GPU.

    python3 tools/wna16_sweep.py [--rows 64 512] [--out sweep.json]

For each of the four fused linears of one Llama-3-8B layer (qkv, o,
gate_up, down), NVFP4 (g16) and W8A16 (g128), and each row count: the
device ms of ``csrc/wna16_matmul.cu`` at every K split (1, 2, 4, 8 blocks
of a cluster) beside the split ``wna16_plan`` picks, each output held
against the plain version by the a8b rule, and ``torch.matmul`` on the
dequantized bf16 weight. Timing as ``chip_smoke.py``'s: CUDA-graph replays
over copies of the weight larger than L2. Prints ptxas's registers and
spills of every kernel of the source first, and one JSON line last; with
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
    import torch

    if not torch.cuda.is_available():
        print("wna16_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from compressed_tensors_tpu_torch.ops.kernels import _build
    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

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
            ("wna16_matmul.cu",)).items()):
        print(f"resources {name}: {regs} registers, {spill} bytes spilled",
              flush=True)

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for kernel, fmt, weight in (("w4a16_fp4_matmul", "nvfp4", "fp4"),
                                ("w4_e8_matmul", "w8a16", "int8")):
        entry = getattr(lib, "ct_" + kernel)
        for m in args.rows:
            for lin, (n, k) in cs.W4_SHAPES_8B.items():
                w, s, _, plain, dense, _ = cs.wna16_ops(kernel, fmt, n, k, gen)
                g = k // s.shape[0]
                x = cs.dev_randn(gen, m, k)
                want = plain(x, w, s)
                bm, picked, _ = w4.wna16_plan(m, n, k)
                tiles = -(-k // 64)
                pairs = [(w.clone(), s.clone()) for _ in range(cs.copies_for(
                    w.numel() * w.element_size() + s.numel() * 4))]
                y = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")

                def run(ww, ss, splits, b):
                    err = entry(x.data_ptr(), ww.data_ptr(), ss.data_ptr(),
                                y.data_ptr(), m, n, k, g, b, splits,
                                -(-tiles // splits),
                                torch.cuda.current_stream().cuda_stream)
                    _build.check(err, kernel)

                times = {}
                for splits in (1, 2, 4, 8):
                    if splits > tiles:
                        continue
                    run(w, s, splits, bm)
                    torch.cuda.synchronize()
                    diff = (y.float() - want).abs()
                    bad = int((diff > cs.A8B_REL * want.abs() + cs.A8B_ABS
                               * want.abs().max()).sum())
                    if bad:
                        raise AssertionError(
                            f"{kernel} {lin} M={m} splits={splits}: {bad} "
                            "elements outside the a8b rule")
                    times[splits] = cs.device_ms(
                        [lambda ww=ww, ss=ss, sp=splits: run(ww, ss, sp, bm)
                         for ww, ss in pairs])
                del pairs
                wd = dense(w, s)
                wds = [wd.clone() for _ in range(cs.copies_for(wd.numel() * 2))]
                lib_ms = cs.device_ms([lambda wd=wd: torch.matmul(x, wd.t())
                                       for wd in wds])
                del wds, wd, w, s
                torch.cuda.empty_cache()
                row = dict(kernel=kernel, fmt=fmt, linear=lin, m=m, n=n, k=k,
                           bm=bm, picked=picked, ms=times, library_ms=lib_ms)
                rows.append(row)
                print(f"{kernel} {fmt} {lin} M={m} bm={bm}: "
                      + ", ".join(f"splits {sp}: {t:.4f} ms"
                                  for sp, t in times.items())
                      + f"; plan {picked}; torch.matmul {lib_ms:.4f} ms",
                      flush=True)
    for kernel in ("w4a16_fp4_matmul", "w4_e8_matmul"):
        for m in args.rows:
            sel = [r for r in rows if r["kernel"] == kernel and r["m"] == m]
            print(f"{kernel} M={m} layer: plan "
                  f"{sum(r['ms'][r['picked']] for r in sel):.4f} ms, best "
                  f"{sum(min(r['ms'].values()) for r in sel):.4f} ms, "
                  f"torch.matmul {sum(r['library_ms'] for r in sel):.4f} ms",
                  flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, rows=rows), f, indent=1)
    print(json.dumps({"device": smi, "rows": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
