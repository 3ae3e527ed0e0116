"""device_idle_pct: share of the traced window in which no operation ran
on the device (profiler timeline), in %."""

from perfbench.tracing import busy_intervals


def read(run):
    tr = run.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    busy = sum(b - a for a, b in busy_intervals(tr.device, tr.t0, tr.t1))
    return 100.0 * (1.0 - busy / tr.window_s)
