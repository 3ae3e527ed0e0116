"""A cell cut to a size the CPU runs in seconds: the same family and mix
kind, widths of 256 (group 128 divides them), two layers, a 512-token
vocabulary, a few slots and short requests. The cells are those of
BENCHMARK.json and the prepared ones below, whose files are kept under
``perfbench/`` for a later benchmark PR to list."""

import copy

import torch

from perfbench import harness

# prepared cells that BENCHMARK.json does not list: their entries
PREPARED = {"qwen3-8b.rag": {"name": "qwen3-8b.rag", "config": "qwen3-8b-w4a16",
                             "traffic": "rag", "chips": 1}}
CELLS = ["qwen2.5-7b.chat", "qwen3-8b.rag"]

TINY_WIDTHS = dict(hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=64, vocab_size=512)


def tiny_cell(name: str) -> harness.Cell:
    # timed runs: two threads, so that parallel test workers do not starve
    # one another's loops
    torch.set_num_threads(2)
    cell = copy.deepcopy(load(name))
    cell.model.update(TINY_WIDTHS)
    t, s = cell.traffic, cell.settings
    if t["loop"] == "closed":
        t.update(clients=4, block=16,
                 prompt=dict(t["prompt"], median=40, min=8, max=96),
                 output=dict(t["output"], median=8, min=4, max=16))
        s["engine"].update(max_batch=4, max_len=128, prefill_chunk=32,
                           num_pages=None, page_size=16)
        s["warmup"].update(ramp_per_step=2, steps=4)
    else:
        t.update(rate_per_s=4.0, block=16,
                 documents=dict(t["documents"], count=4, min=64, max=160),
                 prompt=dict(t["prompt"], min=4, max=12),
                 output=dict(t["output"], min=4, max=10))
        s["engine"].update(max_batch=4, max_len=256, prefill_chunk=64,
                           num_pages=24, page_size=16)
        s["warmup"] = dict(fill_clients=2, fill_requests=12,
                           settle_requests=4)
    s["trace_seconds"] = 1.0
    s["check"].update(requests=6, limit_gap_sd=0.5, limit_mean_gap_sd=0.05)
    return cell


def load(name: str) -> harness.Cell:
    """A cell of BENCHMARK.json, or a prepared one from its files."""
    if name not in PREPARED:
        return harness.load_cell(name)
    work = PREPARED[name]
    root = harness.ROOT / "perfbench"
    return harness.Cell(name, harness.load_json(harness.ROOT
                                                / "BENCHMARK.json"), work,
                        harness.load_json(root / "configs"
                                          / f"{work['config']}.json"),
                        harness.load_json(root / "traffic"
                                          / f"{work['traffic']}.json"),
                        harness.load_json(root / "cells" / f"{name}.json"))
