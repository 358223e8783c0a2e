"""Blocking host-card synchronisations a frame: the port's
``host_syncs`` counter of each window frame's ``engine.step`` (every
read back, boolean-mask index and pageable copy to the card on the
render path goes through ``metrics.host_read``), median over the
frames. Nothing where the program counts none."""

from ptbench import port_trace


def read(run):
    return port_trace.median(run, lambda s: s["host_syncs"])
