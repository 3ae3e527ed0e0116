"""Readings behind the check's limit, on the card: for each seed, one run
of the cell (a window of ``--seconds``) and the widest gap of its served
tokens, and with ``--control`` the widest gap of the token that the
reference computed in fp8 puts first at the same positions. All seeds run
in one process, one after another.

    python3 perfbench/calibrate.py --workload <cell> --seconds 10 --seeds 1 2 3 [--control]

``--w4-act int8`` runs the port on its own int8-row path (the control the
program has of its own); ``--fault <name>`` plants a fault of
``perfbench/faults.py`` underneath the timed path. ``--rates`` runs an
open-loop cell at each of these arrival rates in place of its mix's (the
sweep that finds the highest rate the engine sustains), and with
``--no-check`` leaves the check out. Prints one JSON line per run and a
summary line last.
"""

import argparse
import json
import sys
import time

from run import ROOT, _environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--rates", type=float, nargs="+", default=[None])
    ap.add_argument("--w4-act", choices=("bf16", "int8"))
    ap.add_argument("--fault")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--dump", help="also write each run's gaps, request "
                    "by request, to this file (JSON lines)")
    args = ap.parse_args(argv)
    _environment()
    import torch

    from perfbench import harness
    from perfbench.faults import FAULTS

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    rows = []
    for rate, seed in [(r, s) for r in args.rates for s in args.seeds]:
        t = time.perf_counter()
        cell = harness.load_cell(args.workload)
        if rate is not None:
            cell.traffic["rate_per_s"] = rate
        res = harness.run_cell(
            args.workload, seed, args.seconds, False, "cuda", t, cell=cell,
            control=args.control, check=not args.no_check,
            flags={"w4_act": args.w4_act} if args.w4_act else None,
            hooks=FAULTS[args.fault] if args.fault else None)
        info = res["_info"]
        row = {"seed": seed, "rate": cell.traffic.get("rate_per_s"),
               "w4_act": args.w4_act, "fault": args.fault,
               "correct": res["correct"], "attempted": res["attempted"],
               "failed": res["failed"],
               "queue_at_close": info["queue_at_close"],
               "setup_s": info["setup_s"],
               "widest_gap_sd": res["check"]["widest_gap_sd"]["value"],
               "control_widest_gap_sd": info.get("control_widest_gap_sd"),
               "flips": info["flips"], "control_flips": info.get(
                   "control_flips"),
               "mean_gap_sd": res["check"]["mean_gap_sd"]["value"],
               "control_mean_gap_sd": info.get("control_mean_gap_sd"),
               "served_tokens": info["served_tokens"],
               "sampled_requests": info["sampled_requests"],
               "sampled_slots": info["sampled_slots"],
               "window_counts": info["window_counts"],
               "memory_peak_bytes": res["device"]["memory_peak_bytes"],
               "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.dump:
            with open(args.dump, "a") as f:
                f.write(json.dumps(dict(res["_gaps"], seed=seed,
                                        w4_act=args.w4_act,
                                        fault=args.fault)) + "\n")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    gaps = [r["widest_gap_sd"] for r in rows
            if r["widest_gap_sd"] is not None]
    ctl = [r["control_widest_gap_sd"] for r in rows
           if r["control_widest_gap_sd"] is not None]
    print(json.dumps({"workload": args.workload,
                      "lower": max(gaps) if gaps else None,
                      "upper": min(ctl) if ctl else None, "root": ROOT}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
