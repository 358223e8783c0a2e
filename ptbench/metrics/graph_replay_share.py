"""Share of the window frames' bounce segments that ran as a CUDA graph
replay rather than op by op, in %: the port's ``engine.replay`` spans
(one a replayed segment) over those and its ``engine.segment`` spans (one
a segment issued op by op), summed over the window's frames. Nothing
where no frame records either span: a program without the graph path."""

from ptbench import port_trace

REPLAY, EAGER = "engine.replay", "engine.segment"


def read(run):
    summaries = port_trace.frames(run)
    if not summaries:
        return None
    replays = sum(port_trace.span_ns(s, REPLAY, "count") for s in summaries)
    eager = sum(port_trace.span_ns(s, EAGER, "count") for s in summaries)
    if replays + eager == 0:
        return None
    return 100.0 * replays / (replays + eager)
