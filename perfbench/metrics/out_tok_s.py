"""out_tok_s: every generated token that reached the host inside the
window, over the window's seconds."""


def read(run):
    tokens = sum(n for t, n in run.book.deliveries if run.t0 < t <= run.t1)
    return tokens / run.window_s
