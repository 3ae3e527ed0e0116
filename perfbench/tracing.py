"""Spans, counters and the device trace of a traced run, all taken from
outside the program: the engine's methods and the kernel wrappers are
wrapped from here for the traced window and put back after it.

- Host spans around ``ServingEngine``'s admit, prefill chunk, decode
  burst, retire, page allocation and first-token collection. In the traced
  window a prefill chunk's span ends in a synchronize, so that it holds
  the chunk's device time (a decode burst ends in its host copy anyway).
- The call shapes of B1/B2 (``quantized_matmul``'s ``w4a16_matmul``), B4
  and B7 (``llama_forward``'s ``prefill_attention`` and
  ``paged_decode_attention``), for their roofline bounds.
- The port's kernel launch counters (every ``*launches`` attribute of the
  wrappers in ``ops/kernels``) around each decode burst.
- ``torch.profiler`` over the traced window, CUDA activity only, and a
  marker kernel at each end that puts the device's clock on the host's.
"""

from __future__ import annotations

import dataclasses
import importlib
import pkgutil
import time

from perfbench import roofline

PORT = "compressed_tensors_tpu_torch"
ENGINE_SPANS = {
    "_admit": "admit",
    "_prefill_chunk": "prefill_chunk",
    "_decode": "decode",
    "_retire": "retire",
    "_ensure_burst_pages": "page_alloc",
    "_first_tokens": "first_tokens",
    "_match_prefix": "prefix_match",
}


def launch_counters() -> list:
    """(function, attribute) of every launch counter of the port's kernel
    wrappers."""
    pkg = importlib.import_module(f"{PORT}.ops.kernels")
    found = []
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
        for value in vars(mod).values():
            if callable(value) and getattr(value, "__module__", None) == \
                    mod.__name__:
                for attr, n in vars(value).items() if hasattr(
                        value, "__dict__") else ():
                    if attr.endswith("launches") and isinstance(n, int):
                        found.append((value, attr))
    return found


@dataclasses.dataclass
class Trace:
    """What a traced window recorded; times in host perf_counter seconds."""
    t0: float = 0.0
    t1: float = 0.0
    spans: list = dataclasses.field(default_factory=list)   # (name, a, b, depth)
    prefill: list = dataclasses.field(default_factory=list)  # (rows, start)
    decode: list = dataclasses.field(default_factory=list)  # (lengths, burst)
    decode_launches: int = 0
    matched_tokens: int = 0
    calls: dict = dataclasses.field(default_factory=dict)   # kernel -> [(ops, bytes, peak)]
    device: list | None = None      # (name, a, b) on the host clock
    kernel_time: dict = dataclasses.field(default_factory=dict)
    kernel_launches: dict = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def span_time(self, name: str) -> float:
        return sum(b - a for n, a, b, _ in self.spans if n == name)

    def bound_time(self, kernels) -> float:
        return sum(roofline.bound_s(*c) for k in kernels
                   for c in self.calls.get(k, ()))


class Tracer:
    """Installs the wrappers on one engine; records while ``on``."""

    def __init__(self, engine, device):
        self.engine = engine
        self.cuda = device.type == "cuda"
        self.on = False
        self.trace = Trace()
        self._depth = 0
        self._undo = []
        self._counters = launch_counters()
        self._prof = None
        self._wrap_engine()
        self._wrap_kernels()
        if self.cuda:
            # the profiler's first start loads and sets up CUPTI, which
            # takes seconds: pay it here, in set-up, not in the window
            self.start()
            self.stop()
            self.trace = Trace()

    # -- wrappers ------------------------------------------------------ #
    def _span(self, name, fn, sync=False):
        import torch

        def wrapped(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            a = time.perf_counter()
            self._depth += 1
            try:
                out = fn(*args, **kwargs)
                if sync and self.cuda:
                    torch.cuda.synchronize()
            finally:
                self._depth -= 1
            self.trace.spans.append((name, a, time.perf_counter(),
                                     self._depth))
            self._after(name, args, out)
            return out
        return wrapped

    def _after(self, name, args, out):
        t = self.trace
        if name == "prefill_chunk":
            _, piece, start = args
            t.prefill.append((len(piece), int(start)))
        elif name == "prefix_match":
            t.matched_tokens += int(out)

    def _wrap_engine(self):
        eng = self.engine
        for method, name in ENGINE_SPANS.items():
            prev = getattr(eng, method)
            fn = self._decode(prev) if name == "decode" else prev
            setattr(eng, method, self._span(
                name, fn, sync=name == "prefill_chunk"))
            self._undo.append(lambda m=method, p=prev: setattr(eng, m, p))

    def _decode(self, fn):
        def decode(active, burst):
            if not self.on:
                return fn(active, burst)
            lengths = self.engine._lengths.copy()
            lengths[~active] = -1
            before = sum(getattr(f, a) for f, a in self._counters)
            out = fn(active, burst)
            self.trace.decode_launches += sum(
                getattr(f, a) for f, a in self._counters) - before
            self.trace.decode.append((lengths, burst))
            return out
        return decode

    def _patch(self, module, name, record):
        mod = importlib.import_module(module)
        orig = getattr(mod, name)

        def wrapped(*args, **kwargs):
            if self.on:
                kernel, call = record(*args, **kwargs)
                self.trace.calls.setdefault(kernel, []).append(call)
            return orig(*args, **kwargs)
        setattr(mod, name, wrapped)
        self._undo.append(lambda: setattr(mod, name, orig))

    def _wrap_kernels(self):
        def w4(x, w_packed, scales, zp, *, n, k, group_size, mode="int4b"):
            act = "int8" if mode == "a8b" else "bf16"
            return ("B2" if act == "int8" else "B1",
                    roofline.w4a16(x.shape[0], n, k, group_size, act,
                                   zp is not None))

        def b4(q, k, v, **_):
            b, s, h, d = q.shape
            return "B4", roofline.prefill_attention(b, s, h, k.shape[2], d)

        def b7(q, new_k, new_v, pool_k, pool_v, tables, lengths, **_):
            # the step's (B,) lengths on the device, read after the window
            return "B7", (q.shape[1], q.shape[2], new_k.shape[1], lengths)

        self._patch(f"{PORT}.ops.linear", "w4a16_matmul", w4)
        self._patch(f"{PORT}.models.llama", "prefill_attention", b4)
        self._patch(f"{PORT}.models.llama", "paged_decode_attention", b7)

    # -- the traced window -------------------------------------------- #
    def _marker(self):
        """A synchronized one-element kernel; its host launch time."""
        import torch

        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.empty(1, device=self.engine.device).fill_(1)
        torch.cuda.synchronize()
        return t

    def start(self):
        if self.cuda:
            import torch
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.start()
            self._m0 = self._marker()
        self.trace.t0 = time.perf_counter()
        self.on = True

    def stop(self):
        self.on = False
        if self.cuda:
            import torch

            torch.cuda.synchronize()
        self.trace.t1 = time.perf_counter()
        if self._prof is not None:
            m1 = self._marker()
            self._prof.stop()
            self._read_device(self._m0, m1)
            self._prof = None
        self._finish_calls()

    def uninstall(self):
        for undo in reversed(self._undo):
            undo()
        self._undo = []

    def _finish_calls(self):
        """B7's bounds from the lengths its calls saw."""
        calls = self.trace.calls.get("B7")
        if not calls:
            return
        lens_cache = {}
        done = []
        for h, d, kvh, lengths in calls:
            key = id(lengths)
            if key not in lens_cache:
                lens_cache[key] = lengths.tolist()
            done.append(roofline.paged_decode(lens_cache[key], h, kvh, d))
        self.trace.calls["B7"] = done

    def _read_device(self, m0, m1):
        events = device_events(self._prof)
        if len(events) < 2:
            self.trace.device = []
            return
        events.sort(key=lambda e: e[1])
        # the first and last operations are the markers: their starts less
        # their host launch times put the device clock on the host's
        first, last = events[0], events[-1]
        offset = ((first[1] - m0) + (last[1] - m1)) / 2
        t = self.trace
        dev = [(n, a - offset, b - offset) for n, a, b in events[1:-1]]
        t.device = [e for e in dev if e[2] > t.t0 and e[1] < t.t1]
        prev = None
        for name, a, b in t.device:
            kernel = roofline.kernel_of(name, prev)
            prev = kernel
            if kernel is not None:
                t.kernel_time[kernel] = t.kernel_time.get(kernel, 0.0) + (
                    b - a)
                t.kernel_launches[kernel] = t.kernel_launches.get(
                    kernel, 0) + 1


def device_events(prof) -> list:
    """(name, start s, end s) of every device operation the profiler
    saw, in its clock."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if hasattr(e, "start_ns"):
                a, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            else:
                a, dur = e.start_us() * 1e-6, e.duration_us() * 1e-6
            out.append((e.name(), a, a + dur))
    return out


def busy_intervals(device, t0, t1) -> list:
    """Merged intervals in which some device operation ran, within [t0,
    t1]."""
    merged = []
    for _, a, b in sorted(device, key=lambda e: e[1]):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def idle_by_span(trace: Trace, top: int = 10) -> list:
    """Idle device seconds by the innermost host span open at each gap's
    midpoint ("between_steps" where the harness held the host)."""
    busy = busy_intervals(trace.device, trace.t0, trace.t1)
    edges = [trace.t0] + [x for iv in busy for x in iv] + [trace.t1]
    spans = sorted(trace.spans, key=lambda s: s[1])
    out: dict = {}
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label, depth = "between_steps", -1
        for name, sa, sb, d in spans:
            if sa > mid:
                break
            if sb >= mid and d > depth:
                label, depth = name, d
        out[label] = out.get(label, 0.0) + (b - a)
    return sorted(([k, v] for k, v in out.items()), key=lambda kv: -kv[1])[
        :top]


def short_name(name: str) -> str:
    """A device operation's name without its return type and arguments."""
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:160]


def top_ops(trace: Trace, top: int = 10) -> list:
    totals: dict = {}
    for name, a, b in trace.device:
        key = short_name(name)
        totals[key] = totals.get(key, 0.0) + (b - a)
    return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[
        :top]
