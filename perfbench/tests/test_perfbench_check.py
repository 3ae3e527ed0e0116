"""The check's sample: the longest finished request, then others drawn
from the seed across slots, each compared over all its served tokens."""

import numpy as np

from perfbench import check


def _done(n=40, slots=8):
    rng = np.random.default_rng(0)
    return [(list(range(int(rng.integers(5, 50)))),
             list(range(int(rng.integers(3, 40)))), i % slots)
            for i in range(n)]


def test_sample_takes_the_longest_then_other_slots():
    done = _done()
    picked = check.sample(done, 11, 6)
    assert len(picked) == 6 and len({id(p) for p in picked}) == 6
    assert picked[0] == max(done, key=lambda d: len(d[0]) + len(d[1]))
    assert len({p[2] for p in picked}) == 6


def test_sample_is_drawn_from_the_seed():
    done = _done()
    assert check.sample(done, 11, 6) == check.sample(done, 11, 6)
    assert check.sample(done, 11, 6) != check.sample(done, 12, 6)


def test_sample_reuses_slots_only_when_it_must():
    done = _done(n=20, slots=3)
    picked = check.sample(done, 1, 10)
    assert len(picked) == 10 and len({p[2] for p in picked}) == 3
    assert len({p[2] for p in picked[:3]}) == 3
    assert len(check.sample(done, 1, 50)) == 20


def test_compared_positions_are_the_served_tokens():
    prompt, out = [7, 8, 9], [1, 2, 3, 4, 5]
    seqs, positions = check._inputs([(prompt, out, 0)])
    assert seqs == [[7, 8, 9, 1, 2, 3, 4]]
    # position p predicts the token at p + 1
    assert positions == [[2, 3, 4, 5, 6]]
    assert [seqs[0][p + 1] for p in positions[0][:-1]] == out[:-1]
