"""Host ms a frame issuing the counter-based generator's ops: the self
time of the port's ``shade.rng`` spans (the public entries of
``ops/rng``, less their synchronising copies), median over the window's
frames."""

from ptbench import port_trace


def read(run):
    return port_trace.median(
        run, lambda s: port_trace.span_ns(s, "shade.rng", "self_ns") * 1e-6)
