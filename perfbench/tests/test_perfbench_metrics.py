"""The end-to-end readers over synthetic timelines: taken over the whole
window and every request, so a stall moves them."""

import math
import types

import pytest

from perfbench import harness
from perfbench.stats import percentile
from perfbench.traffic import Item


def _run(tracks, deliveries, t0=0.0, t1=10.0):
    book = types.SimpleNamespace(tracks={i: t for i, t in enumerate(tracks)},
                                 deliveries=deliveries, finished=[])
    run = harness.Run.__new__(harness.Run)
    run.book, run.t0, run.t1, run.trace, run.setup_s = book, t0, t1, None, 1
    return run


def _track(due, first, last, n, done=True):
    return harness.Track(Item(0, [1], n), due, first, last, n,
                         last if done else None, [0] * n if done else None)


def _steady(stall_at=None, stall=0.0):
    """Requests due each 0.1 s, 10 tokens 20 ms apart after a 50 ms first
    token; a stall delays everything from ``stall_at`` by ``stall``."""
    tracks, deliveries = [], []
    for i in range(100):
        due = i * 0.1
        times = [due + 0.05 + 0.02 * j for j in range(10)]
        if stall_at is not None:
            times = [t + stall if t >= stall_at else t for t in times]
        tracks.append(_track(due, times[0], times[-1], 10))
        deliveries += [(t, 1) for t in times]
    return tracks, deliveries


def read(name, run):
    return harness.reader(name).read(run)


def test_steady_values():
    run = _run(*_steady())
    assert read("ttft_p90_ms", run) == pytest.approx(50.0)
    # tokens of requests whose last tokens fall past the window are out
    n = sum(1 for t, _ in run.book.deliveries if 0 < t <= 10)
    assert read("out_tok_s", run) == pytest.approx(n / 10)


def test_a_stall_moves_every_metric():
    calm = _run(*_steady())
    stalled = _run(*_steady(stall_at=4.0, stall=3.0))
    assert read("out_tok_s", stalled) < read("out_tok_s", calm)
    assert read("ttft_p90_ms", stalled) > 2 * read("ttft_p90_ms", calm)


def test_tails_count_missing_requests():
    tracks, deliveries = _steady()
    for t in tracks[::20]:          # a twentieth never start
        t.first = None
    assert read("ttft_p90_ms", _run(tracks, deliveries)) == pytest.approx(
        50.0)
    for t in tracks[::8]:           # past a tenth: p90 is a missing one
        t.first = None
    assert read("ttft_p90_ms", _run(tracks, deliveries)) is None


def test_tail_is_over_all_requests():
    tracks, deliveries = _steady()
    for t in tracks[:15]:           # 15% of the requests are slow
        t.first += 1.0
    assert read("ttft_p90_ms", _run(tracks, deliveries)) == pytest.approx(
        1050.0)


def test_percentile():
    xs = list(range(1, 101))
    assert percentile(xs, 90) == 90 and percentile(xs, 100) == 100
    assert percentile([1, math.inf], 90) == math.inf
