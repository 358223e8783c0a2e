"""The reader of ``graph_replay_share`` (the port's ``engine.replay``
spans over those and its ``engine.segment`` spans, over the window's
frames) on fixed tables of step summaries, and in a small traced run of
a cell on the CPU, where every segment runs op by op
(``python -m pytest ptbench/tests``)."""

import pytest

from ptbench import port_trace, spec
from ptbench.tests import _tiny

NAME = "graph_replay_share"


def read(run):
    return spec.metric_module(NAME).read(run)


def _summary(step, replays, eager):
    spans = {"engine.bounce": {"count": 8, "total_ns": 9, "self_ns": 5}}
    for name, n in (("engine.replay", replays), ("engine.segment", eager)):
        if n:
            spans[name] = {"count": n, "total_ns": 4, "self_ns": 1}
    return {"step": step, "start_ns": 0, "end_ns": 1, "host_syncs": 1,
            "host_wait_ns": 0, "spans": spans}


class FakePort:
    def __init__(self, table):
        self.table = table

    def steps(self):
        return list(self.table)


def test_reads_the_replayed_share_of_the_windows_segments(monkeypatch):
    # Set-up's warm frame (op by op), then a window whose first frame runs
    # op by op and is captured, and three that replay.
    table = [_summary(0, 0, 2), _summary(1, 0, 2), _summary(2, 2, 0),
             _summary(3, 2, 0), _summary(4, 1, 1)]
    monkeypatch.setattr(port_trace, "_port", FakePort(table))
    assert read({"frame_ms": [1.0] * 4}) == pytest.approx(100.0 * 5 / 8)
    assert read({"frame_ms": [1.0] * 2}) == pytest.approx(75.0)


@pytest.mark.parametrize("table", [
    None,                                     # a program without spans
    [],                                       # no steps recorded
    [_summary(i, 0, 0) for i in range(4)],    # no segment spans
], ids=["no_spans", "no_steps", "no_segment_spans"])
def test_reads_nothing_without_segments(monkeypatch, table):
    monkeypatch.setattr(port_trace, "_port",
                        None if table is None else FakePort(table))
    assert read({"frame_ms": [1.0, 2.0]}) is None


def test_the_cpu_runs_every_segment_op_by_op():
    r = _tiny.run_tiny("cornell_mesh6.progressive", trace=True)
    assert r["correct"]
    assert r["metrics"][NAME] == {"value": 0.0, "unit": "%"}
