"""``msamples_per_s`` of the tile scheduler's cell, whose rate spreads more
than the progressive cells' (PERF.md, section 2), so that it has a bound
of its own: the same reader."""

from ptbench import spec

_base = spec.metric_beside(__file__, "msamples_per_s")
read = _base.read
