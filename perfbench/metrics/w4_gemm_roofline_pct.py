"""w4_gemm_roofline_pct: B1 and B2 (the W4A16 GEMM at bf16 and at int8
activations) over the traced window: the sum of their calls' roofline
bounds (perfbench/roofline.py, from each call's shape) over their measured
device time, in %."""

KERNELS = ("B1", "B2")


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    busy = sum(tr.kernel_time.get(k, 0.0) for k in KERNELS)
    if busy <= 0:
        return None
    return 100.0 * tr.bound_time(KERNELS) / busy
