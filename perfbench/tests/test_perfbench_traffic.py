"""The traffic generator: deterministic for a seed, the same sizes for
every seed, and the distributions its mixes state."""

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from perfbench.traffic import Traffic, quantiles, zipf_counts

ROOT = Path(__file__).resolve().parents[2]


def mix(name):
    return json.loads((ROOT / "perfbench" / "traffic"
                       / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["chat", "rag"])
def test_deterministic_for_a_seed(name):
    a, b = Traffic(mix(name), 2**31 + 5, 1000), Traffic(mix(name),
                                                         2**31 + 5, 1000)
    for i in (0, 1, 77, 300):
        x, y = a.item(i), b.item(i)
        assert (x.prompt, x.max_new, x.doc) == (y.prompt, y.max_new, y.doc)
    other = Traffic(mix(name), 6, 1000)
    assert [other.item(i).prompt for i in range(4)] != [
        a.item(i).prompt for i in range(4)]


@pytest.mark.parametrize("name", ["chat", "rag"])
def test_every_seed_same_sizes_per_block(name):
    spec = mix(name)
    b = spec["block"]

    def sizes(seed):
        t = Traffic(spec, seed, 1000)
        return Counter((len(t.item(i).prompt), t.item(i).max_new)
                       for i in range(b, 2 * b))

    assert sizes(1) == sizes(987654321)
    t1, t2 = Traffic(spec, 1, 1000), Traffic(spec, 2, 1000)
    order1 = [len(t1.item(i).prompt) for i in range(8)]
    order2 = [len(t2.item(i).prompt) for i in range(8)]
    assert order1 != order2
    if not t1.closed:
        assert sorted(t1.gaps(1)) == sorted(t2.gaps(1))
        assert list(t1.gaps(1)) != list(t2.gaps(1))


def test_chat_distributions():
    spec = mix("chat")
    t = Traffic(spec, 3, 152064)
    items = [t.item(i) for i in range(spec["block"])]
    prompts = np.array([len(x.prompt) for x in items])
    outs = np.array([x.max_new for x in items])
    assert prompts.min() >= 32 and prompts.max() <= 1536
    assert outs.min() >= 16 and outs.max() <= 512
    assert abs(np.median(prompts) - 400) <= 10
    assert abs(np.median(outs) - 160) <= 5
    # lognormal sigma from the inner quantiles (the clamps cut the tails)
    q25, q75 = np.percentile(np.log(prompts), [25, 75])
    assert abs((q75 - q25) / 1.349 - 0.8) < 0.05
    # unshared: no two prompts share their first 16 ids
    assert len({tuple(x.prompt[:16]) for x in items}) == len(items)
    assert all(0 <= i < 152064 for x in items for i in x.prompt)


def test_rag_documents_and_arrivals():
    spec = mix("rag")
    t = Traffic(spec, 4, 151936)
    docs = spec["documents"]
    assert sorted(t.doc_sizes) == sorted(quantiles(docs, docs["count"]))
    assert min(t.doc_sizes) >= 2048 and max(t.doc_sizes) <= 6144
    items = [t.item(i) for i in range(spec["block"])]
    by_doc = Counter(x.doc for x in items)
    counts = zipf_counts(docs["count"], docs["zipf_s"], spec["block"])
    assert by_doc == Counter({d: int(c) for d, c in enumerate(counts) if c})
    # a request is its document's ids, then a question of its own
    for x in items:
        n = int(t.doc_sizes[x.doc])
        assert x.prompt[:n] == t.doc_tokens(x.doc)
        assert 32 <= len(x.prompt) - n <= 128 and 16 <= x.max_new <= 96
    gaps = t.gaps(0)
    assert abs(gaps.mean() * spec["rate_per_s"] - 1) < 0.01
    # exponential: the median gap is ln 2 of the mean
    assert abs(np.median(gaps) * spec["rate_per_s"] - np.log(2)) < 0.02
    dues = t.due_times(10.0)
    assert all(0 < a < b < 10 for a, b in zip(dues, dues[1:]))
    assert abs(len(dues) - 10 * spec["rate_per_s"]) <= spec["block"]
    # from a later request on: request first + i is due after its own gap
    first = spec["block"] + 3
    later = t.due_times(10.0, first)
    gaps = np.concatenate([t.gaps(1), t.gaps(2)])[3:]
    assert np.allclose(later, np.cumsum(gaps)[:len(later)])
    assert t.due_times(1e9, first, 5) == later[:5]


def test_rag_window_holds_one_block():
    """Every block spans just under the benchmark's window and its next
    arrival falls just past it, so a window opened at a block's start
    holds that block's requests, the same sizes for every seed."""
    spec = mix("rag")
    seconds = json.loads((ROOT / "BENCHMARK.json").read_text())[
        "run_seconds"]
    for seed in (1, 2**31 + 9):
        t = Traffic(spec, seed, 1000)
        dues = t.due_times(seconds, spec["block"])
        assert len(dues) == spec["block"]
        assert seconds - t.gaps(2).min() < dues[-1] < seconds


def test_zipf_counts():
    c = zipf_counts(64, 1.0, 128)
    assert c.sum() == 128 and all(np.diff(c) <= 0)
    assert c[0] == round(128 / sum(1 / r for r in range(1, 65)))
