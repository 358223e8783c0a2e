"""Median host time of the present (``progressive.resolve``,
``utils.image.tonemap`` and the copy of the 8-bit image to the host) over
the traced run's frames, each timed from a synchronise after the frame's
step: ms."""

import statistics


def read(run):
    p = run.get("present_ms")
    return statistics.median(p) if p else None
