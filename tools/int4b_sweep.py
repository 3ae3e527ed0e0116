#!/usr/bin/env python3
"""Design sweep of the int4b W4A16 kernel (B1, ``csrc/w4a16_matmul.cu``) on
one GPU.

    python3 tools/int4b_sweep.py [--rows 1 16 64 512 8192] [--models 8B tiny]
                                 [--out sweep.json]

For each row count and each of the four fused linears of one Llama-3-8B or
TinyLlama-1.1B layer (W4A16 g128): the device ms of the design that takes
the rows (decode rows up to 64 with 128 weight rows a block; prefill
rows on 128 x 192 tiles) at K splits of 1, 2, 4 and 8 blocks of a
cluster and at the plan's split, each output held to the a8b rule against
the plain f32 version first, beside the design and split ``int4b_plan``
picks and ``torch.matmul`` on the dequantized bf16 weight. Timing as
``chip_smoke.py``'s: CUDA-graph replays over copies of the weight larger
than L2. Prints ptxas's registers, spills and wgmma serialization warnings
of the int4b kernels first and one JSON line last; with ``--out`` also
writes every row to that JSON file.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MODELS = {"8B": "W4_SHAPES_8B", "tiny": "W4_SHAPES"}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("int4b_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from compressed_tensors_tpu_torch.ops.kernels import _build
    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 16, 64, 512])
    ap.add_argument("--models", nargs="+", default=["8B", "tiny"],
                    choices=sorted(MODELS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(verbose=False)
    lib = _build.load()
    serialized = {}
    report = _build.ptxas_report(("w4a16_matmul.cu",), serialized)
    for name, (regs, spill) in sorted(cs.kernel_resources(report).items()):
        if "int4b" in name:
            print(f"resources {name}: {regs} registers, {spill} bytes "
                  "spilled", flush=True)
    for name, codes in sorted(cs.kernel_resources(serialized).items()):
        print(f"wgmma serialized in {name}: {codes}", flush=True)
    rng = np.random.default_rng(5)
    rows = []
    for model in args.models:
        shapes = getattr(cs, MODELS[model])
        for m in args.rows:
            for lin, (n, k) in shapes.items():
                rows.append(sweep_linear(cs, w4, lib, rng, model, lin, m, n,
                                         k))
            sel = [r for r in rows if r["model"] == model and r["m"] == m]
            plan = sum(r["ms"][r["picked"]] for r in sel)
            best = sum(min(r["ms"].values()) for r in sel)
            print(f"int4b {model} layer M={m}: {plan:.4f} ms at the plan "
                  f"(best design and split {best:.4f}); torch.matmul "
                  f"{sum(r['library_ms'] for r in sel):.4f} ms", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, rows=rows), f, indent=1)
    print(json.dumps({"device": smi, "rows": len(rows)}))
    return 0


def sweep_linear(cs, w4, lib, rng, model, lin, m, n, k, group=128):
    """The design that takes M rows (decode rows, M <= 64: 128 weight rows
    a block; prefill rows: 128 x 192 tiles) at K splits of 1, 2, 4 and 8
    blocks of a cluster and at the plan's split: each held to the a8b rule,
    then timed. Returns the linear's row."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import _build

    x, w, s, _ = cs.w4_inputs(rng, n, k, m, torch.device("cuda"))
    want = w4.w4a16_matmul_plain(x, w, s, None, n=n, k=k, group_size=group,
                                 out_dtype=torch.float32)
    slack = cs.A8B_REL * want.abs() + cs.A8B_ABS * want.abs().max()
    ws = [w.clone() for _ in range(cs.copies_for(n * k // 2))]
    y = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    tiles = k // 64
    bm, splits, _ = w4.int4b_plan(m, n, k)
    design = w4.int4b_design(m)

    def run(ww, sp):
        per = -(-tiles // sp)
        _build.check(lib.ct_w4a16_matmul(
            x.data_ptr(), ww.data_ptr(), s.data_ptr(), None, y.data_ptr(), m,
            n, k, group, bm, -(-tiles // per), per,
            torch.cuda.current_stream().cuda_stream), "int4b")

    times = {}
    for sp in sorted({1, 2, 4, 8, splits}):
        per = -(-tiles // sp)
        if sp > tiles or -(-tiles // per) != sp:
            continue  # the same blocks as a smaller split
        run(w, sp)
        torch.cuda.synchronize()
        bad = int(((y.float() - want).abs() > slack).sum())
        if bad:
            raise AssertionError(f"int4b {model} {lin} M={m} {design} x{sp}: "
                                 f"{bad} elements outside the a8b rule")
        times[f"{design} x{sp}"] = cs.device_ms(
            [lambda ww=ww, sp=sp: run(ww, sp) for ww in ws])
    picked = f"{design} x{splits}"
    del ws
    wd = w4._dequantized_weight(w, s, None, n, k, group).to(torch.bfloat16)
    wds = [wd.clone() for _ in range(cs.copies_for(wd.numel() * 2))]
    lib_ms = cs.device_ms([lambda wd=wd: torch.matmul(x, wd.t()) for wd in wds])
    del wds, wd, want, slack
    torch.cuda.empty_cache()
    best = min(times, key=times.get)
    print(f"int4b {model} {lin} M={m}: " + ", ".join(
        f"{key} {t:.4f}" for key, t in times.items())
        + f" ms; plan {picked} {times[picked]:.4f}, best {best}; torch.matmul "
        f"{lib_ms:.4f} ms", flush=True)
    return dict(model=model, linear=lin, m=m, n=n, k=k, picked=picked,
                ms=times, library_ms=lib_ms)


if __name__ == "__main__":
    sys.exit(main())
