"""One run of one cell: draw the model from the seed, build the port's
``ServingEngine`` over it, bring the cell's traffic to a steady state
(set-up), measure for ``seconds``, then check the served tokens against
the plain reference and report.

Everything that belongs to one cell, configuration, traffic mix or metric
is a file found by name: ``BENCHMARK.json`` at the root names the cell's
configuration and mix and lists the metrics; ``perfbench/cells/<cell>.json``
holds the engine settings, the warm-up and the check's limit;
``perfbench/configs/`` the model, whose ``family`` names its draw
(``perfbench/models/<family>.py``) and reference
(``perfbench/reference/<family>.py``); ``perfbench/traffic/<mix>.json``
the traffic; ``perfbench/metrics/<metric>.py`` (or ``<base>.py`` for
``<base>.<suffix>``) the reader of each metric.

The port runs at the precision the configuration states: its
``quantization.activations`` sets the port's ``w4_act`` option, so a
W4A16 configuration runs every W4 linear at bf16 activations.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

from perfbench.traffic import Item, Traffic

ROOT = Path(__file__).resolve().parents[1]
# what no process that prints a result may have loaded (top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "compressed_tensors_tpu")
# how long past the window's close a request due in it may take
DRAIN_S = 60.0
# the port's w4_act option for each activation precision a configuration
# states
W4_ACT = {"bfloat16": "bf16", "int8": "int8"}


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    bench: dict        # BENCHMARK.json
    workload: dict     # its entry for this cell
    model: dict        # the configuration's file
    traffic: dict      # the mix's file
    settings: dict     # perfbench/cells/<cell>.json

    @property
    def family(self) -> str:
        return self.model["family"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    works = {w["name"]: w for w in bench["workloads"]}
    if name not in works:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    work = works[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    return Cell(name, bench, work, load_json(root / conf["file"]),
                load_json(root / "perfbench" / "traffic"
                          / f"{work['traffic']}.json"),
                load_json(root / "perfbench" / "cells" / f"{name}.json"))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Track:
    """One request as the host saw it; times on the host clock."""
    item: Item
    due: float
    first: float | None = None
    last: float | None = None
    n: int = 0
    done: float | None = None
    output: list | None = None
    slot: int | None = None


class Book:
    """Requests submitted to one engine and the tokens that reached the
    host: a first token when the engine collects it at admission, the
    others when the step that made them returns. It also counts the
    prefix-cached pages the pool evicts."""

    def __init__(self, engine):
        self.engine = engine
        self.tracks: dict[int, Track] = {}
        self.deliveries: list = []     # (time, tokens)
        self.finished: list = []       # tracks in completion order
        self.queue_at_close = None
        self.evicted_pages = 0
        self.at_open = self.at_close = None
        orig = engine._first_tokens

        def first_tokens(first):
            orig(first)
            now = time.perf_counter()
            for slot in first:
                rid = engine.slot_requests[slot].request_id
                self.tracks[rid].slot = slot
                self._seen(rid, 1, now)
        engine._first_tokens = first_tokens
        if getattr(engine, "paged", False):
            alloc = engine._alloc_page

            def alloc_page():
                if not engine._free_pages and engine._cached_free:
                    self.evicted_pages += 1
                return alloc()
            engine._alloc_page = alloc_page

    def counters(self) -> dict:
        """The engine's counters now."""
        eng = self.engine
        return {"evicted_pages": self.evicted_pages,
                "preemptions": eng.preemptions,
                "prefix_pages_hit": eng.prefix_cache_hits}

    def mark(self, which: str):
        setattr(self, which, self.counters())

    def submit(self, item: Item, due: float):
        from compressed_tensors_tpu_torch.engine import Request

        self.tracks[item.index] = Track(item, due)
        self.engine.submit(Request(request_id=item.index,
                                   prompt_ids=item.prompt,
                                   max_new_tokens=item.max_new))

    def _seen(self, rid: int, n: int, now: float):
        tr = self.tracks[rid]
        if n > tr.n:
            if tr.first is None:
                tr.first = now
            self.deliveries.append((now, n - tr.n))
            tr.n, tr.last = n, now

    def collect(self) -> list:
        """After a step: new tokens of the running requests and the
        requests that finished; returns the finished tracks."""
        now = time.perf_counter()
        eng = self.engine
        for slot, req in enumerate(eng.slot_requests):
            if req is not None:
                self._seen(req.request_id, len(eng.slot_outputs[slot]), now)
        done = []
        for c in eng.completions:
            self._seen(c.request_id, len(c.output_ids), now)
            tr = self.tracks[c.request_id]
            tr.done, tr.output = now, list(c.output_ids)
            done.append(tr)
        eng.completions.clear()
        self.finished += done
        return done


class Run:
    """What the metric readers read."""

    def __init__(self, cell: Cell, book: Book, t0: float, t1: float,
                 setup_s: float, trace=None):
        self.cell, self.book = cell, book
        self.t0, self.t1, self.setup_s = t0, t1, setup_s
        self.trace = trace
        self.model = cell.model
        # the engine's counters over the window
        a, b = book.at_open, book.at_close
        self.counts = {k: b[k] - a[k] for k in a} if a and b else {}

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def due_in_window(self) -> list:
        return [t for t in self.book.tracks.values()
                if self.t0 < t.due <= self.t1]


# ---------------------------------------------------------------------- #
# the traffic loops

def closed_loop(book: Book, traffic: Traffic, warm: dict, seconds: float,
                tracer=None):
    """``clients`` callers, each sending its next request when its last
    completes: ``ramp_per_step`` join a step, then ``steps`` more steps of
    warm-up; the window starts at a step boundary and ends at the first
    boundary ``seconds`` after it. Returns (t0, t1)."""
    clients = traffic.spec["clients"]
    nxt = 0
    eng = book.engine

    def send(now):
        nonlocal nxt
        book.submit(traffic.item(nxt), now)
        nxt += 1

    joined = 0
    while joined < clients:
        for _ in range(min(warm["ramp_per_step"], clients - joined)):
            send(time.perf_counter())
            joined += 1
        eng.step()
        for _ in book.collect():
            send(time.perf_counter())
    for _ in range(warm["steps"]):
        eng.step()
        for _ in book.collect():
            send(time.perf_counter())
    if tracer is not None:
        tracer.start()
    book.mark("at_open")
    t0 = time.perf_counter()
    trace_end = t0 + warm.get("trace_seconds", seconds)
    while True:
        eng.step()
        for _ in book.collect():
            send(time.perf_counter())
        now = time.perf_counter()
        if tracer is not None and tracer.on and now >= trace_end:
            tracer.stop()
        if now >= t0 + seconds:
            break
    book.mark("at_close")
    if tracer is not None and tracer.on:
        tracer.stop()
    return t0, now


def fill(book: Book, traffic: Traffic, warm: dict) -> int:
    """The first part of an open-loop mix's warm-up: its first
    ``fill_requests`` requests, each with one new token, served back to
    back by ``fill_clients`` callers (the prefix cache then holds the
    documents used last, as after a long run); the engine drains. Returns
    the next request's index."""
    limit = warm.get("fill_requests", 0)
    eng = book.engine
    sent = inflight = 0
    while True:
        while inflight < warm.get("fill_clients", 1) and sent < limit:
            item = dataclasses.replace(traffic.item(sent), max_new=1)
            book.submit(item, time.perf_counter())
            sent += 1
            inflight += 1
        if not inflight:
            return sent
        eng.step()
        inflight -= len(book.collect())


def open_loop(book: Book, traffic: Traffic, warm: dict, seconds: float,
              tracer=None):
    """After ``fill``, arrivals on the mix's schedule from the next
    request on: ``settle_requests`` of them settle the queue, and the
    window opens at the last one's due time, which is a block's start, so
    that every seed's window holds the same sizes and gaps (a block spans
    the window where the mix's rate is set so). After the window the
    schedule goes on until every request due in it has finished, or
    ``DRAIN_S`` has passed. Returns (t0, t1)."""
    eng = book.engine
    first = fill(book, traffic, warm)
    settle = warm["settle_requests"]
    if (first + settle) % traffic.block:
        raise ValueError("fill_requests + settle_requests must be whole "
                         "blocks of the mix")
    lead = traffic.due_times(math.inf, first, settle)[-1] if settle else 0.0
    base = time.perf_counter()
    dues = [base + d for d in traffic.due_times(lead + seconds + DRAIN_S,
                                                first)]
    start = base + lead
    nxt = 0
    t0 = t1 = None
    trace_end = None

    def busy():
        return eng.queue or any(r is not None for r in eng.slot_requests)

    while True:
        now = time.perf_counter()
        while nxt < len(dues) and dues[nxt] <= now:
            book.submit(traffic.item(first + nxt), dues[nxt])
            nxt += 1
        if t0 is None and now >= start:
            if tracer is not None:
                tracer.start()
            book.mark("at_open")
            t0 = start
            trace_end = t0 + warm.get("trace_seconds", seconds)
        if t0 is not None:
            if tracer is not None and tracer.on and now >= trace_end:
                tracer.stop()
            if t1 is None and now >= t0 + seconds:
                t1 = t0 + seconds
                book.queue_at_close = len(eng.queue)
                book.mark("at_close")
                if tracer is not None and tracer.on:
                    tracer.stop()
            if t1 is not None:
                pending = [t for t in book.tracks.values()
                           if t0 < t.due <= t1 and t.done is None]
                if not pending or now >= t1 + DRAIN_S:
                    return t0, t1
        if busy():
            eng.step()
            book.collect()
        elif nxt < len(dues):
            time.sleep(max(0.0, min(dues[nxt] - time.perf_counter(),
                                    0.01)))
        else:
            if t1 is None:
                t1 = time.perf_counter()
                book.mark("at_close")
            return t0, t1


# ---------------------------------------------------------------------- #

def _module(kind: str, family: str):
    return importlib.import_module(f"perfbench.{kind}.{family}")


def reader(name: str, root: Path = ROOT):
    """The reader of metric ``name``: ``metrics/<name>.py``, else
    ``metrics/<base>.py`` for ``<base>.<suffix>``."""
    d = root / "perfbench" / "metrics"
    for stem in (name, name.split(".")[0]):
        path = d / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"perfbench.metrics.{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise SystemExit(f"no reader for metric {name!r}")


def cell_metrics(cell: Cell, kind: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics this cell
    reports."""
    return [m for m in cell.bench[kind]
            if "workloads" not in m or cell.name in m["workloads"]]


def read_metrics(run: Run, metrics: list) -> dict:
    out = {}
    for m in metrics:
        value = reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def program_flags(cfg: dict) -> dict:
    """The port's options that make it run at the configuration's stated
    precision."""
    return {"w4_act": W4_ACT[cfg["quantization"]["activations"]]}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, root: Path = ROOT, cell: Cell | None = None,
             hooks=None, control: bool = False, flags: dict | None = None,
             check: bool = True) -> dict:
    """One run; returns the result line's object. ``device`` "cuda" is a
    measured run; "cpu" a rehearsal whose line carries no device metric.
    ``hooks(engine)``, for tests, may wrap the engine before the warm-up.
    For ``perfbench/calibrate.py`` (the benchmark's runs use none of
    these): ``control`` also reads the fp8 control's widest gap on the
    same sample, ``flags`` overrides the port's options (its int8-row
    path, the other control), ``check=False`` leaves the check out."""
    from compressed_tensors_tpu_torch.flags import flag_overrides

    if seed < 0:
        raise SystemExit("--seed must be a whole number >= 0")
    cell = cell or load_cell(name, root)
    with flag_overrides(**dict(program_flags(cell.model), **(flags or {}))):
        return _run_cell(cell, seed, seconds, trace, device, t_start, hooks,
                         control, check)


def _run_cell(cell, seed, seconds, trace, device, t_start, hooks, control,
              check):
    import torch

    from compressed_tensors_tpu_torch.engine import ServingEngine

    device = torch.device(device)
    cuda = device.type == "cuda"
    cfg = cell.model
    models = _module("models", cell.family)
    params, config = models.serve_params(models.draw(cfg, seed, device), cfg)
    eng = ServingEngine(params, config, dtype=torch.bfloat16, device=device,
                        **cell.settings["engine"])
    del params
    if hooks is not None:
        hooks(eng)
    book = Book(eng)
    tracer = None
    if trace:
        from perfbench.tracing import Tracer

        tracer = Tracer(eng, device)
    traffic = Traffic(cell.traffic, seed, cfg["vocab_size"])
    loop = closed_loop if traffic.closed else open_loop
    warm = dict(cell.settings["warmup"])
    if trace:
        warm["trace_seconds"] = min(seconds, cell.settings["trace_seconds"])
    t_loop = time.perf_counter()
    t0, t1 = loop(book, traffic, warm, seconds, tracer)
    if cuda:
        torch.cuda.synchronize()
    setup_s = t0 - t_start
    run = Run(cell, book, t0, t1, setup_s,
              tracer.trace if tracer is not None else None)
    found = forbidden_modules()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    kind = "per_layer" if trace else "end_to_end"
    metrics = cell_metrics(cell, kind)
    if not cuda:
        metrics = [m for m in metrics if m["source"] == "program_counter"]
    values = read_metrics(run, metrics)

    # the check, once the program is freed
    due = run.due_in_window()
    finished_due = [t for t in due if t.done is not None]
    missing = (len(due) - len(finished_due)) if not traffic.closed else 0
    in_window = ([t for t in book.finished if t0 < t.done <= t1]
                 if traffic.closed else finished_due)
    wrong_len = sum(len(t.output) != t.item.max_new for t in book.finished)
    if tracer is not None:
        tracer.uninstall()
    del eng, book.engine, tracer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    chk = cell.settings["check"]
    from perfbench import check as checking

    picked = checking.sample(
        [(t.item.prompt, t.output, t.slot) for t in in_window], seed,
        chk["requests"]) if check else []
    reference = _module("reference", cell.family)
    reference.check_family(cfg)
    gaps, ctl = np.zeros(0), None
    if picked:
        raw = models.draw(cfg, seed, device)
        gaps = checking.served_gaps(reference, cfg, raw, picked, device)
        if control:
            ctl = checking.control_gaps(reference, cfg, raw, picked, device)
        del raw
    widest = float(gaps.max()) if gaps.size else None
    mean = float(gaps.mean()) if gaps.size else None
    compared = {
        "widest_gap_sd": {"value": widest, "limit": chk["limit_gap_sd"]},
        "mean_gap_sd": {"value": mean, "limit": chk["limit_mean_gap_sd"]},
        "wrong_lengths": {"value": wrong_len, "limit": 0},
        "missing": {"value": missing, "limit": 0},
        "jax_modules": {"value": len(found), "limit": 0},
    }
    correct = (widest is not None and widest <= chk["limit_gap_sd"]
               and mean <= chk["limit_mean_gap_sd"]
               and wrong_len == 0 and missing == 0 and not found)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1 if cuda else 0,
           "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(due),
              "failed": missing, "metrics": values, "device": dev}
    info_trace = None
    if run.trace is not None:
        from perfbench import tracing

        tr = run.trace
        info_trace = {"device_ops": len(tr.device or ()),
                      "kernel_launches": tr.kernel_launches,
                      "calls": {k: len(v) for k, v in tr.calls.items()},
                      "kernel_s": tr.kernel_time,
                      "bound_s": {k: tr.bound_time((k,)) for k in tr.calls}}
        if tr.device is not None:
            dev["busy_s"] = sum(b - a for a, b in tracing.busy_intervals(
                tr.device, tr.t0, tr.t1))
            dev["window_s"] = tr.window_s
            result["breakdown"] = {"device_ops": tracing.top_ops(tr),
                                   "idle_gaps": tracing.idle_by_span(tr)}
    result["check"] = compared
    result["_found"] = found
    cuts = np.cumsum([len(p[1]) for p in picked])[:-1]
    result["_gaps"] = {"program": [g.tolist() for g in np.split(gaps, cuts)],
                       "control": None if ctl is None else [
                           g.tolist() for g in np.split(ctl, cuts)]}
    result["_info"] = {"setup_s": setup_s, "warmup_s": t0 - t_loop,
                       "queue_at_close": book.queue_at_close,
                       "window_s": run.window_s,
                       "sampled_requests": len(picked),
                       "sampled_slots": len({p[2] for p in picked}),
                       "served_tokens": int(gaps.size),
                       "finished_in_window": len(in_window),
                       "flips": int((gaps > 0).sum()),
                       "window_counts": run.counts,
                       "trace": info_trace}
    if ctl is not None:
        result["_info"]["control_widest_gap_sd"] = float(ctl.max())
        result["_info"]["control_flips"] = int((ctl > 0).sum())
        result["_info"]["control_mean_gap_sd"] = float(ctl.mean())
    return result


def emit(result: dict) -> int:
    """Print the check's numbers last on standard error and the result
    line last on standard output; the exit code."""
    found = sorted(set(result.pop("_found")) | set(forbidden_modules()))
    result.pop("_gaps", None)
    info = result.pop("_info")
    print(json.dumps({"info": info}), file=sys.stderr)
    if found:
        print(f"modules that must not be loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for key, c in result["check"].items():
        print(f"{key} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
