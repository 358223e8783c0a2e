"""Host ms a frame in the trace queries: the total of the port's
``trace.closest`` and ``trace.occluded`` spans (``scene.intersect_batch``
and ``scene.occluded_batch``: the sphere pass, route choice, binning and
the kernels' launches), median over the window's frames."""

from ptbench import port_trace


def read(run):
    return port_trace.median(
        run, lambda s: (port_trace.span_ns(s, "trace.closest")
                        + port_trace.span_ns(s, "trace.occluded")) * 1e-6)
