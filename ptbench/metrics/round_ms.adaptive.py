"""Median host time of one greedy round of ``render_adaptive_tiles``,
between two of its ``progress`` callbacks (each ended by a synchronise)
over the rounds between them: ms."""

import statistics


def read(run):
    r = run.get("round_ms")
    return statistics.median(r) if r else None
