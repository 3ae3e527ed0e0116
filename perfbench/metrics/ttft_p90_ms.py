"""ttft_p90_ms: from each request's due time to its first token on the
host, p90 over every request due in the window; one that never got its
first token counts as missing (infinitely late)."""

import math

from perfbench.stats import percentile


def read(run):
    due = run.due_in_window()
    if not due:
        return None
    v = percentile([(t.first - t.due) * 1e3 if t.first is not None
                    else math.inf for t in due], 90)
    return v if math.isfinite(v) else None
