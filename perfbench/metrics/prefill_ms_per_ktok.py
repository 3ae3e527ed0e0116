"""prefill_ms_per_ktok: all prefill time in the traced window over the
prompt tokens it computed, per 1000 tokens."""


def read(run):
    tr = run.trace
    rows = sum(r for r, _ in tr.prefill) if tr is not None else 0
    if not rows:
        return None
    return tr.span_time("prefill_chunk") / rows * 1e6
