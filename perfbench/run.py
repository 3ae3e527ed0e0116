"""Run one benchmark cell once on the card(s) of this machine:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations, traffic mixes and metrics are those of
``BENCHMARK.json`` at the root of the checkout. The last line of standard
output is the result as one JSON object; the numbers the check compared,
each beside its limit, are the last lines of standard error. Without a
CUDA card, or with fewer cards than the cell asks for, it prints no result
and exits 2.
"""

import argparse
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment():
    """Refuse the port's flag variables (the flags stay "auto"); keep every
    build and kernel cache at a fixed path inside the checkout."""
    flags = sorted(k for k in os.environ if k.startswith("CT_TORCH_"))
    if flags:
        raise SystemExit(f"unset the port's flag variables: {flags}")
    cache = os.path.join(ROOT, "build", "perfbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from perfbench import harness

    cell = harness.load_cell(args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from compressed_tensors_tpu_torch.ops.kernels import _build

    _build.load()
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START, cell=cell)
    return harness.emit(result)


if __name__ == "__main__":
    sys.exit(main())
