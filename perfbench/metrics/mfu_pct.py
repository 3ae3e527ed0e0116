"""mfu_pct: the model FLOPs of every token the traced window processed
(prompt tokens prefilled and generated tokens of active rows; the linears,
attention over the live context, the lm_head where it was computed) over
the window's seconds at the H100's dense bf16 peak, in %."""

from perfbench import roofline


def read(run):
    tr = run.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    tokens = pairs = heads = 0
    for rows, start in tr.prefill:
        tokens += rows
        pairs += roofline.causal_pairs(start, rows)
        heads += 1
    for lengths, burst in tr.decode:
        live = [int(n) for n in lengths if n >= 0]
        for i in range(burst):
            tokens += len(live)
            heads += len(live)
            pairs += sum(live) + (i + 1) * len(live)
    flops = roofline.model_flops(run.model, tokens, pairs, heads)
    return 100.0 * flops / (tr.window_s * roofline.PEAK["bf16"])
