"""Host ms a frame issuing the shading: the self time of the port's
``engine.bounce`` spans (each ``shading.bounce_batch`` call less its
generator, trace-query and synchronising children), median over the
window's frames."""

from ptbench import port_trace


def read(run):
    return port_trace.median(
        run,
        lambda s: port_trace.span_ns(s, "engine.bounce", "self_ns") * 1e-6)
