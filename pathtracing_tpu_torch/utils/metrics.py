"""Render metrics (the JAX package's ``utils/metrics.py``): Mrays/s,
samples/s, step timing and a JSONL sink; and the engine's spans and
host-sync counter.

``Timer`` reads the card's own time: when the timed work runs on a CUDA
device it synchronizes before it reads the clock (PyTorch returns before
the card finishes).

Spans (``span``, ``step``) and blocking host reads (``host_read``,
``to_device``) are recorded only between ``enable()`` and ``disable()``;
off, a span is one shared no-op object handed out after one check of a
module variable, and a host read is the bare call. On, each span inside
an ``engine.step`` records its name, its parent's name, the step id and
its start and end from ``time.time_ns()`` (the clock of the profiler's
host events, so records join a device trace: ``idle_by_span``), and each
step leaves a summary in a ring (``steps()``): per span name its count,
total and self ns (the total less the time its child spans cover), and
the step's ``host_syncs`` and ``host_wait_ns``. A span opened inside an
open span of the same name is not recorded again. The records keep to
the thread that renders.

Inside ``capturing()`` (a CUDA graph capture, ``models.graphs``) a
blocking host read cannot be recorded: ``host_read`` and ``to_device``
raise ``CaptureUnsafe`` instead of reading, whether tracing is on or off,
and no span is recorded. A replayed graph adds the spans of the work it
ran to the step's counts (``add_spans``), with no time and no record.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import json
import time
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import torch

from pathtracing_tpu_torch.utils import logging as ptlog


def rays_per_sample(width: int, height: int, max_depth: int,
                    avg_path_length: Optional[float] = None) -> float:
    """Rays traced for one sample of every pixel: ``max_depth`` a path
    (the worst case) unless a measured ``avg_path_length`` is given."""
    per_path = avg_path_length if avg_path_length is not None else max_depth
    return float(width * height) * per_path


@dataclass
class StepMetrics:
    step: int
    seconds: float
    samples_added: int
    total_spp: int
    mrays_per_s: float
    samples_per_s: float


@dataclass
class MetricsLog:
    jsonl_path: Optional[str] = None
    history: List[StepMetrics] = field(default_factory=list)

    def record(self, m: StepMetrics) -> None:
        self.history.append(m)
        ptlog.log_information(
            "step %d: %.3fs  %+d spp (total %d)  %.1f Mrays/s  %.2e samples/s",
            m.step, m.seconds, m.samples_added, m.total_spp,
            m.mrays_per_s, m.samples_per_s,
        )
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(m.__dict__) + "\n")


class Timer:
    """Wall-clock context timer. With ``device`` a CUDA device it calls
    ``torch.cuda.synchronize(device)`` before reading the clock at exit,
    so the time covers the work queued on the card inside the block."""

    def __init__(self, device=None) -> None:
        self.device = None if device is None else torch.device(device)

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds = time.perf_counter() - self.start
        return False


# --- Spans and the host-sync counter ----------------------------------------

STEP = "engine.step"
SYNC_PREFIX = "sync."
RANGE_PREFIX = "pt::"
STEP_RING = 4096      # step summaries kept
RAW_STEPS = 16        # steps whose raw records are kept, for the join


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[str]   # the enclosing recorded span's name
    step: int
    start_ns: int           # time.time_ns()
    end_ns: int


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("tracer", "name", "start", "child_ns", "range")

    def __init__(self, tracer, name):
        self.tracer = tracer
        self.name = name
        self.child_ns = 0
        self.range = None

    def __enter__(self):
        tr = self.tracer
        if tr.ranges:
            from torch.autograd.profiler import record_function

            self.range = record_function(RANGE_PREFIX + self.name)
            self.range.__enter__()
        tr.stack.append(self)
        tr.open_names[self.name] += 1
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        tr = self.tracer
        tr.stack.pop()
        tr.open_names[self.name] -= 1
        total = end - self.start
        parent = tr.stack[-1] if tr.stack else None
        if parent is not None:
            parent.child_ns += total
        agg = tr.agg.get(self.name)
        if agg is None:
            agg = tr.agg[self.name] = [0, 0, 0]
        agg[0] += 1
        agg[1] += total
        agg[2] += total - self.child_ns
        tr.records.append(SpanRecord(
            self.name, None if parent is None else parent.name, tr.step_id,
            self.start, end))
        if parent is None:
            tr.close_step(self.start, end)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class _Tracer:
    """The open spans of the rendering thread and what finished steps
    left: summaries of the last ``STEP_RING`` steps, raw records of the
    last ``RAW_STEPS``."""

    def __init__(self):
        self.ranges = False
        self.summaries = collections.deque(maxlen=STEP_RING)
        self.raw = collections.deque(maxlen=RAW_STEPS)
        self.next_step = 0
        self.stack = []
        self.open_names = collections.Counter()
        self.step_id, self.agg, self.records, self.host_syncs = -1, {}, [], 0

    def start_step(self):
        self.step_id = self.next_step
        self.next_step += 1
        self.agg = {}
        self.records = []
        self.host_syncs = 0

    def span(self, name):
        if not self.stack:
            if name != STEP:
                return _NO_SPAN       # outside a step: not recorded
            self.start_step()
        elif self.open_names[name]:
            return _NO_SPAN           # re-entry: recorded once
        return _Span(self, name)

    def close_step(self, start, end):
        spans = {n: {"count": c, "total_ns": t, "self_ns": s}
                 for n, (c, t, s) in self.agg.items()}
        wait = sum(a[1] for n, a in self.agg.items()
                   if n.startswith(SYNC_PREFIX))
        self.summaries.append({
            "step": self.step_id, "start_ns": start, "end_ns": end,
            "spans": spans, "host_syncs": self.host_syncs,
            "host_wait_ns": wait})
        self.raw.append(self.records)

    def read(self, site, fn, args, syncs):
        if not self.stack:
            return fn(*args)
        with self.span(SYNC_PREFIX + site):
            out = fn(*args)
        self.host_syncs += syncs
        return out


_store = _Tracer()
_tracer = None        # _store while tracing is on


def enable(ranges: bool = False) -> None:
    """Turn spans and the host-sync counter on. ``ranges``: each recorded
    span also opens ``torch.profiler.record_function("pt::" + name)``,
    for a profile no benchmark reads (a range's device-side annotation is
    an event of the device trace)."""
    global _tracer
    _store.ranges = bool(ranges)
    _tracer = _store


def disable() -> None:
    """Turn recording off (what was recorded stays readable)."""
    global _tracer
    _tracer = None


def reset() -> None:
    """Forget every summary and record (on/off and ``ranges`` are kept)."""
    ranges = _store.ranges
    _store.__init__()
    _store.ranges = ranges


def steps() -> list:
    """Summaries of the last ``STEP_RING`` finished steps, oldest first:
    ``step``, ``start_ns``, ``end_ns``, ``spans`` {name: {``count``,
    ``total_ns``, ``self_ns``}}, ``host_syncs``, ``host_wait_ns``."""
    return list(_store.summaries)


def records() -> list:
    """The raw ``SpanRecord``s of the last ``RAW_STEPS`` finished steps."""
    return [r for step in _store.raw for r in step]


def span(name: str):
    """A context manager recording a span ``name`` (module docstring)."""
    t = _tracer
    if t is None:
        return _NO_SPAN
    return t.span(name)


def step():
    """The root span ``engine.step`` of one engine step (a frame, or a
    scheduler round); each opens a new step id."""
    t = _tracer
    if t is None:
        return _NO_SPAN
    return t.span(STEP)


def traced(name: str):
    """Decorator: the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            t = _tracer
            if t is None:
                return fn(*args, **kwargs)
            with t.span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def add_spans(name: str, n: int) -> None:
    """Counts ``n`` more spans ``name`` in the open step, of no host time
    and with no record: work that a replayed CUDA graph runs without the
    host's issue (``models.graphs``)."""
    t = _tracer
    if t is None or not t.stack or not n:
        return
    agg = t.agg.get(name)
    if agg is None:
        agg = t.agg[name] = [0, 0, 0]
    agg[0] += n


class CaptureUnsafe(RuntimeError):
    """A blocking host read inside ``capturing()``."""


_capturing = False


@contextlib.contextmanager
def capturing():
    """The block is a CUDA graph capture: host reads raise
    ``CaptureUnsafe``, and no span inside it is recorded (what it issues
    runs at the replays)."""
    global _capturing, _tracer
    saved, _capturing, _tracer = _tracer, True, None
    try:
        yield
    finally:
        _capturing, _tracer = False, saved


def host_read(site: str, fn, *args, syncs: int = 1):
    """``fn(*args)``, the port's one way to make a blocking host read
    (a value read back, a boolean-mask index, a copy from pageable host
    memory: each ends with a stream synchronise on a CUDA device).
    Evaluates exactly ``fn(*args)``; with tracing on, inside a step, it
    adds ``syncs`` (the synchronising operations ``fn`` makes) to the
    step's ``host_syncs`` and times the call as the span ``sync.<site>``,
    the host's wait for the card to drain its queue. Inside
    ``capturing()`` it raises ``CaptureUnsafe``."""
    if _capturing:
        raise CaptureUnsafe(f"host read {site!r} inside a graph capture")
    t = _tracer
    if t is None:
        return fn(*args)
    return t.read(site, fn, args, syncs)


def masked(mask, *xs):
    """``x[mask]`` of each x, for ``host_read``: a boolean-mask index reads
    its count back, one blocking read each."""
    return tuple(x[mask] for x in xs)


def _tensor(data, dtype, device):
    return torch.tensor(data, dtype=dtype, device=device)


def to_device(site: str, data, dtype, device):
    """``torch.tensor(data, dtype=dtype, device=device)`` through
    ``host_read``: on a CUDA device a copy from pageable host memory,
    which PyTorch ends with a stream synchronise. Inside ``capturing()``
    it raises ``CaptureUnsafe``."""
    if _capturing:
        raise CaptureUnsafe(f"copy {site!r} inside a graph capture")
    t = _tracer
    if t is None:
        return torch.tensor(data, dtype=dtype, device=device)
    return t.read(site, _tensor, (data, dtype, device), 1)


NO_SPAN = "no span"


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _device_intervals(events) -> list:
    """(start ns, end ns) of every device op among a profile's kineto
    events (``prof.profiler.kineto_results.events()``): the device events
    less the hidden ones and the device side of range annotations."""
    from torch.autograd import DeviceType

    out = []
    for ev in events:
        if (ev.device_type() == DeviceType.CPU or ev.is_hidden_event()
                or ev.is_user_annotation()
                or ev.name().startswith(RANGE_PREFIX)):
            continue
        out.append((ev.start_ns(), ev.end_ns()))
    return out


def idle_by_span(events, span_records, window=None) -> dict:
    """The card's idle ms in a profile, by the innermost port span open on
    the host meanwhile: {span name or "no span": ms}, largest first.
    Busy time is the union of the device ops (``_device_intervals``);
    ``window`` (start ns, end ns) defaults to the records' extent."""
    busy = _merge(_device_intervals(events))
    if window is None:
        if not span_records:
            return {}
        window = (min(r.start_ns for r in span_records),
                  max(r.end_ns for r in span_records))
    lo, hi = window
    starts = [a for a, _ in busy]
    before = [0]                      # busy ns before each interval
    for a, b in busy:
        before.append(before[-1] + b - a)

    def busy_until(t):
        i = bisect.bisect_right(starts, t)
        if i == 0:
            return 0
        a, b = busy[i - 1]
        return before[i - 1] + min(t, b) - a

    def idle(a, b):
        a, b = max(a, lo), min(b, hi)
        return 0 if b <= a else (b - a) - (busy_until(b) - busy_until(a))

    # Elementary intervals between span edges, each named by the
    # innermost span open across it (records nest: one thread).
    edges = sorted({lo, hi} | {t for r in span_records
                               for t in (r.start_ns, r.end_ns)
                               if lo <= t <= hi})
    order = sorted(span_records, key=lambda r: (r.start_ns, -r.end_ns))
    out = collections.Counter()
    stack, j = [], 0
    for a, b in zip(edges, edges[1:]):
        while stack and stack[-1].end_ns <= a:
            stack.pop()
        while j < len(order) and order[j].start_ns <= a:
            if order[j].end_ns > a:
                stack.append(order[j])
            j += 1
        name = stack[-1].name if stack else NO_SPAN
        out[name] += idle(a, b)
    return {n: ns * 1e-6 for n, ns in out.most_common() if ns > 0}
