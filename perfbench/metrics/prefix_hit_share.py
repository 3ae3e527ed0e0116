"""prefix_hit_share: prompt tokens served from the prefix cache over
prompt tokens admitted (served from the cache plus prefilled) in the
traced window, in %."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    computed = sum(rows for rows, _ in tr.prefill)
    total = computed + tr.matched_tokens
    return 100.0 * tr.matched_tokens / total if total else None
