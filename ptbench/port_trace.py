"""The port's own spans and host-sync counter
(``pathtracing_tpu_torch.utils.metrics``), as the engine's host-side
per-layer metrics read them.

Importing this module turns the port's spans on (``metrics.enable()``).
The per-layer readers that import it are loaded only in ``--trace 1``
runs, before set-up, so a traced run records every step, the warm-up's
too, while the untraced runs that give the end-to-end metrics record
nothing. A program without spans (no ``enable``) records nothing, and
every reader of it reads nothing."""

from __future__ import annotations

import statistics

try:
    from pathtracing_tpu_torch.utils import metrics as _port

    _port.enable()
except (ImportError, AttributeError):
    _port = None


def frames(run):
    """The port's step summaries of the window's frames: its last
    ``len(run["frame_ms"])`` steps (set-up's warm frame comes before
    them). None where the program records no steps, or too few."""
    n = len(run.get("frame_ms") or ())
    if _port is None or not n:
        return None
    steps = _port.steps()
    return steps[-n:] if len(steps) >= n else None


def span_ns(summary: dict, name: str, key: str = "total_ns") -> int:
    """``key`` (``count``, ``total_ns`` or ``self_ns``) of the span
    ``name`` in one step summary (0 where the step has none)."""
    return summary["spans"].get(name, {}).get(key, 0)


def median(run, value):
    """Median over the window's frames of ``value(summary)``; None
    without summaries."""
    summaries = frames(run)
    if not summaries:
        return None
    return statistics.median(value(s) for s in summaries)
