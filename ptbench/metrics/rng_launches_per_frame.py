"""Kernel launches a frame of the counter-based generator: the count of
the port's ``rng.launch`` spans (one a launch of the kernels of
``csrc/rng.cu``, nested in ``shade.rng``) in each window frame's step,
median over the frames. Nothing where no frame records such a span: a
program without the kernels, or one on the CPU, where the generator takes
its plain version."""

from ptbench import port_trace

SPAN = "rng.launch"


def read(run):
    summaries = port_trace.frames(run)
    if not summaries or not any(SPAN in s["spans"] for s in summaries):
        return None
    return port_trace.median(
        run, lambda s: port_trace.span_ns(s, SPAN, "count"))
