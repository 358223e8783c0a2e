"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over a few
frames or rounds, reduced to the table the per-layer metrics read.

The reduction reads the profiler's raw kineto events (``prof.events()``
would first build a Python tree of every host op: tens of seconds for
10^5 device ops). Every device event but the hidden ones and the device
side of range annotations is a device op. A device op belongs to a
benchmark span (``span``) when the host op that launched it started
inside that span's host interval. Busy time is the union of the device
ops' intervals; the window is the host clock's, from a synchronise to a
synchronise."""

from __future__ import annotations

import bisect
import re
import time

SPAN_PREFIX = "ptbench::"
# The traversal kernels (the port's csrc/cluster_trace*.cu), by name.
TRAVERSAL_KERNEL = re.compile(r"\b(trace|occluded)_\w*_kernel\b")
# Op names in the breakdown are cut to this length (template arguments).
NAME_CHARS = 160


def span(label: str):
    """A host range the table attributes device ops to."""
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + label)


class Profiler:
    """Start and stop around a region that both ends synchronise."""

    def __init__(self, sync):
        self.sync = sync
        self.prof = None
        self.t0 = 0.0

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> dict:
        self.sync()
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        return reduce_events(self.prof.profiler.kineto_results.events(),
                             window_s)


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_events(events, window_s: float) -> dict:
    """The table of one profiled window: ``window_s``, ``busy_s``,
    ``device_ops``, ``by_name`` {name: [seconds, count]}, ``by_span``
    {label: seconds} and ``traversal`` {"s", "launches"} (device ops
    launched inside each benchmark span), ``top_ops`` and ``idle_gaps``
    (at most 10 each: the device ops that took most time, and the longest
    device idle gaps named by the innermost host op running across
    them)."""
    from torch.autograd import DeviceType

    ranges = []       # (start ns, end ns, label)
    host = []         # (start ns, end ns, name) of host ops
    op_start = {}     # correlation id -> launching host op's start
    dev = []          # (start ns, end ns, name, correlation id)
    for ev in events:
        if ev.is_hidden_event():
            continue
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            if name.startswith(SPAN_PREFIX):
                ranges.append((ev.start_ns(), ev.end_ns(),
                               name[len(SPAN_PREFIX):]))
            else:
                host.append((ev.start_ns(), ev.end_ns(), name))
                if ev.correlation_id():
                    op_start.setdefault(ev.correlation_id(), ev.start_ns())
            continue
        if ev.device_type() != DeviceType.CUDA or name.startswith(
                SPAN_PREFIX):
            continue
        dev.append((ev.start_ns(), ev.end_ns(), name,
                    ev.linked_correlation_id()))
    by_name = {}
    trav_s, trav_n = 0.0, 0
    for a, b, name, _ in dev:
        rec = by_name.setdefault(name, [0.0, 0])
        rec[0] += (b - a) * 1e-9
        rec[1] += 1
        if TRAVERSAL_KERNEL.search(name):
            trav_s += (b - a) * 1e-9
            trav_n += 1
    by_span = {}
    for label in sorted({lb for _, _, lb in ranges}):
        merged = _merge((a, b) for a, b, lb in ranges if lb == label)
        starts = [a for a, _ in merged]
        total = 0.0
        for a, b, _, cid in dev:
            t = op_start.get(cid)
            i = -1 if t is None else bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= merged[i][1]:
                total += (b - a) * 1e-9
        by_span[label] = total
    busy = _merge((a, b) for a, b, _, _ in dev)
    busy_s = sum(b - a for a, b in busy) * 1e-9
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1],
                    busy[i + 1][0]) for i in range(len(busy) - 1)),
                  reverse=True)[:10]
    host.sort()
    host_starts = [a for a, _, _ in host]
    idle = []
    for length, a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(host_starts, mid) - 1
        what = "no host op"
        for j in range(i, max(i - 512, -1), -1):
            if host[j][1] >= mid:
                what = host[j][2]
                break
        idle.append([what, length * 1e-9])
    top = sorted(((n, v[0]) for n, v in by_name.items()),
                 key=lambda kv: -kv[1])[:10]
    return {"window_s": window_s, "busy_s": busy_s, "device_ops": len(dev),
            "by_name": by_name, "by_span": by_span,
            "traversal": {"s": trav_s, "launches": trav_n},
            "top_ops": [[n[:NAME_CHARS], s] for n, s in top],
            "idle_gaps": [[n[:NAME_CHARS], s] for n, s in idle]}
