"""The one traffic generator: every mix is a JSON file of parameters in
``perfbench/traffic/`` that this module reads.

Sizes and gaps come in blocks of ``block`` requests. Every block holds the
same multiset: each length distribution's quantiles at (i + 0.5) / block,
paired prompt-to-output by a fixed permutation, the documents' popularity
counts of the block, and the exponential gaps' quantiles. The seed draws
the token ids and orders each block, so every seed does the same work in
another order. A block's gaps sum to the same span for every seed, so a
window that opens at a block's start and lasts that span holds the same
sizes for every seed.

A mix is a closed loop (``clients`` callers, each sending its next request
when the last completes) or an open loop (arrivals at ``rate_per_s``,
timed from their due time). With ``documents``, a request's prompt is one
of a pool of documents (lengths uniform between ``min`` and ``max``,
popularity Zipf with exponent ``zipf_s``) followed by a question of its
own; without, the prompt is its own.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np

# fixed: the sizes every seed shares
SIZES_SEED = 20240521


@dataclasses.dataclass
class Item:
    index: int
    prompt: list
    max_new: int
    doc: int | None = None


def quantiles(dist: dict, n: int) -> np.ndarray:
    """``n`` integer values of ``dist`` at the probabilities (i + 0.5)/n,
    clamped to [min, max]."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(p) for p in u])
        v = dist["median"] * np.exp(dist["sigma"] * z)
    elif kind == "uniform":
        v = dist["min"] + u * (dist["max"] + 1 - dist["min"])
    elif kind == "exponential":
        v = -dist["mean"] * np.log1p(-u)
        return v  # gaps stay real
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    return np.clip(np.floor(v), dist["min"], dist["max"]).astype(np.int64)


def zipf_counts(n_items: int, s: float, total: int) -> np.ndarray:
    """Counts of items of ranks 1..n_items among ``total`` draws of a Zipf
    law with exponent s, rounded by largest remainder."""
    p = 1.0 / np.arange(1, n_items + 1) ** s
    exact = total * p / p.sum()
    counts = np.floor(exact).astype(np.int64)
    short = total - counts.sum()
    counts[np.argsort(-(exact - counts), kind="stable")[:short]] += 1
    return counts


class Traffic:
    """Requests of one mix for one seed, by index."""

    def __init__(self, spec: dict, seed: int, vocab: int):
        self.spec = spec
        self.seed = int(seed)
        self.vocab = vocab
        self.block = spec["block"]
        fixed = np.random.default_rng(SIZES_SEED)
        b = self.block
        self.prompt_sizes = fixed.permutation(quantiles(spec["prompt"], b))
        self.output_sizes = fixed.permutation(quantiles(spec["output"], b))
        docs = spec.get("documents")
        if docs:
            self.doc_sizes = fixed.permutation(quantiles(docs, docs["count"]))
            counts = zipf_counts(docs["count"], docs["zipf_s"], b)
            # rank r is document r - 1
            self.block_docs = np.repeat(np.arange(docs["count"]), counts)
        self._orders: dict[int, np.ndarray] = {}
        self._gaps: dict[int, np.ndarray] = {}
        self._doc_tokens: dict[int, list] = {}

    @property
    def closed(self) -> bool:
        return self.spec["loop"] == "closed"

    def _rng(self, *key) -> np.random.Generator:
        return np.random.default_rng([self.seed, *key])

    def _order(self, blk: int) -> np.ndarray:
        if blk not in self._orders:
            self._orders[blk] = self._rng(0, blk).permutation(
                self.block)
        return self._orders[blk]

    def _tokens(self, n: int, *key) -> list:
        return self._rng(*key).integers(0, self.vocab, n).tolist()

    def doc_tokens(self, doc: int) -> list:
        if doc not in self._doc_tokens:
            self._doc_tokens[doc] = self._tokens(int(self.doc_sizes[doc]),
                                                 1, doc)
        return self._doc_tokens[doc]

    def item(self, index: int) -> Item:
        blk, pos = divmod(index, self.block)
        j = int(self._order(blk)[pos])
        prompt = self._tokens(int(self.prompt_sizes[j]), 2, index)
        doc = None
        if self.spec.get("documents"):
            doc = int(self.block_docs[j])
            prompt = self.doc_tokens(doc) + prompt
        return Item(index, prompt, int(self.output_sizes[j]), doc)

    def gaps(self, blk: int) -> np.ndarray:
        """Seconds between the arrivals of block ``blk`` (open loop)."""
        if blk not in self._gaps:
            mean = 1.0 / self.spec["rate_per_s"]
            g = quantiles({"dist": "exponential", "mean": mean}, self.block)
            self._gaps[blk] = self._rng(3, blk).permutation(g)
        return self._gaps[blk]

    def due_times(self, horizon_s: float, first: int = 0,
                  count: int | None = None) -> list[float]:
        """Due times, from 0, of the open loop's arrivals before
        ``horizon_s`` (at most ``count`` of them): request ``first + i`` is
        due at the i-th, each after its own gap."""
        out, t, index = [], 0.0, first
        while count is None or len(out) < count:
            blk, pos = divmod(index, self.block)
            t += float(self.gaps(blk)[pos])
            if t >= horizon_s:
                break
            out.append(t)
            index += 1
            if index - first > 10_000_000 or not math.isfinite(t):
                raise ValueError("rate too low for the horizon")
        return out
