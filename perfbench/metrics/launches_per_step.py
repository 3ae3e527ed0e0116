"""launches_per_step: launches of the port's kernels (their wrappers'
launch counters) in the traced window's decode bursts over its decode
steps."""


def read(run):
    tr = run.trace
    steps = sum(burst for _, burst in tr.decode) if tr is not None else 0
    if not steps or not tr.decode_launches:
        return None
    return tr.decode_launches / steps
