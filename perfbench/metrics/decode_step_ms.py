"""decode_step_ms: all decode time in the traced window (the engine's
decode bursts, each ending in its host copy) over its decode steps."""


def read(run):
    tr = run.trace
    steps = sum(burst for _, burst in tr.decode) if tr is not None else 0
    if not steps:
        return None
    return tr.span_time("decode") / steps * 1e3
