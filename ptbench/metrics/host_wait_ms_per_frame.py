"""Host ms a frame blocked in the port's synchronising reads: the total
of a frame's ``sync.*`` spans (``host_wait_ns``), the host waiting while
the card drains its queue, median over the window's frames."""

from ptbench import port_trace


def read(run):
    return port_trace.median(run, lambda s: s["host_wait_ns"] * 1e-6)
