"""``device_ops_per_msample`` of the tile scheduler's cell, where it moves
``msamples_per_s.adaptive``: the same reader."""

from ptbench import spec

_base = spec.metric_beside(__file__, "device_ops_per_msample")
PROFILE_UNITS = _base.PROFILE_UNITS
read = _base.read
