"""prefill_time_share: share of the traced window's wall time inside the
engine's prefill chunks (spans synchronized at their end), in %."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * tr.span_time("prefill_chunk") / tr.window_s
