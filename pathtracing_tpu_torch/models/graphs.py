"""CUDA graphs of the engine's segments: capture once, replay after.

``capture(fn, device, share)`` records what ``fn`` issues on the card as
a ``torch.cuda.CUDAGraph`` on a side stream and returns a ``Graph``
whose ``replay()`` launches it on the current stream: the host issues one
graph launch where it issued each op. A graph captured with ``share`` (a
``Graph``) takes that graph's memory pool, so the graphs of one wave hold
one pool between them, freed with the last of them; they replay one at a
time, in stream order, and each holds its outputs. ``fn`` runs under
``metrics.capturing()``, so a blocking host read inside it
(``metrics.host_read``) raises ``metrics.CaptureUnsafe`` before it syncs;
that capture is thrown away and ``capture`` returns None, the caller's
sign to stay op by op. A capture that fails on the card is thrown away
too, with a warning. Capture what has run eagerly once with the same
shapes and tables: that run builds the kernels, loads their libraries
and caches the scene's device tables, none of which a capture may do.

The kernels a capture launches are taken back off ``cluster_trace.
LAUNCHES``, ``pgather.LAUNCHES`` and ``rng.LAUNCHES`` (a capture launches
nothing) and added again at every replay, so the counts still say what
ran; the generator's launches are also counted as ``rng.launch`` spans
of no host time (``metrics.add_spans``). Spans (``utils.metrics``):
``engine.capture`` around a capture; ``engine.replay`` around each
replay, holding an ``engine.bounce`` span, the host's issue of the
replayed bounces.
"""

from __future__ import annotations

import torch

from pathtracing_tpu_torch.ops import cluster_trace, pgather, rng
from pathtracing_tpu_torch.utils import logging as ptlog
from pathtracing_tpu_torch.utils import metrics

CAPTURE_SPAN = "engine.capture"
REPLAY_SPAN = "engine.replay"

# The launch counters a capture takes back and a replay adds again.
_TABLES = {"ct": cluster_trace.LAUNCHES, "pg": pgather.LAUNCHES,
           "rng": rng.LAUNCHES}
_STREAMS = {}               # device -> the side stream captures run on


def _launch_counts() -> dict:
    return {(t, k): v for t, table in _TABLES.items()
            for k, v in table.items()}


def _set_launch_counts(counts: dict) -> None:
    for (t, name), v in counts.items():
        _TABLES[t][name] = v


class Graph:
    """A captured segment: the graph, what ``fn`` returned (the graph's
    static outputs, rewritten by each replay) and the kernel launches the
    capture recorded."""

    __slots__ = ("graph", "out", "launches")

    def __init__(self, graph, out, launches):
        self.graph, self.out, self.launches = graph, out, launches

    def replay(self):
        """Launch the graph on the current stream; returns ``out``."""
        with metrics.span(REPLAY_SPAN), metrics.span("engine.bounce"):
            self.graph.replay()
        for (t, name), n in self.launches.items():
            _TABLES[t][name] += n
        metrics.add_spans(rng.LAUNCH_SPAN, sum(
            n for (t, _), n in self.launches.items() if t == "rng"))
        return self.out


def capture(fn, device, share=None):
    """``fn()`` captured as a ``Graph`` on ``device`` (a CUDA device) in
    ``share``'s memory pool (a new pool without it), or None where it
    cannot be (see the module docstring)."""
    device = torch.device(device)
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    pool = (torch.cuda.graph_pool_handle() if share is None
            else share.graph.pool())
    before = _launch_counts()
    graph = torch.cuda.CUDAGraph()
    try:
        with metrics.span(CAPTURE_SPAN), metrics.capturing(), \
                torch.cuda.stream(_STREAMS[device]):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                graph.capture_end()
    except metrics.CaptureUnsafe as err:
        _set_launch_counts(before)
        ptlog.log_information("segment runs op by op: %s", err)
        return None
    except RuntimeError as err:
        _set_launch_counts(before)
        ptlog.log_warning("segment runs op by op: its capture failed: %s",
                          err)
        return None
    after = _launch_counts()
    _set_launch_counts(before)
    return Graph(graph, out, {k: after[k] - before[k] for k in after
                              if after[k] != before[k]})
