"""attn_roofline_pct: B4 (prefill attention of fresh chunks) and B7 (paged
decode attention) over the traced window: the sum of their calls'
roofline bounds over their measured device time, in %."""

KERNELS = ("B4", "B7")


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    busy = sum(tr.kernel_time.get(k, 0.0) for k in KERNELS)
    if busy <= 0:
        return None
    return 100.0 * tr.bound_time(KERNELS) / busy
