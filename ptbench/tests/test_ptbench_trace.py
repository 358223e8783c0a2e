"""The readers of the port's own spans and host-sync counter
(``port_trace`` and its five metrics) on a fixed table of step
summaries, and a small traced run of a cell on the CPU that reports them
(``python -m pytest ptbench/tests``)."""

import pytest

from ptbench import port_trace, spec
from ptbench.tests import _tiny

NEW = ("host_syncs_per_frame", "host_wait_ms_per_frame",
       "rng_host_ms_per_frame", "shade_host_ms_per_frame",
       "trace_host_ms_per_frame")


def read(name, run):
    return spec.metric_module(name).read(run)


def _summary(step, syncs, wait_ms, rng_self_ms, bounce_self_ms, closest_ms,
             occluded_ms):
    ns = 1_000_000

    def sp(total, self_ms=None):
        return {"count": 8, "total_ns": int(total * ns),
                "self_ns": int((total if self_ms is None else self_ms) * ns)}

    return {"step": step, "start_ns": 0, "end_ns": 1, "host_syncs": syncs,
            "host_wait_ns": int(wait_ms * ns),
            "spans": {"shade.rng": sp(rng_self_ms + 1.0, rng_self_ms),
                      "engine.bounce": sp(bounce_self_ms + 50.0,
                                          bounce_self_ms),
                      "trace.closest": sp(closest_ms),
                      "trace.occluded": sp(occluded_ms)}}


# Set-up's warm frame (step 0, far off) and three window frames.
TABLE = [_summary(0, 500, 900.0, 900.0, 900.0, 900.0, 900.0),
         _summary(1, 42, 70.0, 120.0, 40.0, 6.0, 3.0),
         _summary(2, 42, 90.0, 110.0, 50.0, 8.0, 2.0),
         _summary(3, 44, 80.0, 130.0, 45.0, 7.0, 4.0)]


class FakePort:
    def __init__(self, table):
        self.table = table

    def steps(self):
        return list(self.table)


@pytest.fixture
def table(monkeypatch):
    monkeypatch.setattr(port_trace, "_port", FakePort(TABLE))


def test_readers_on_a_fixed_table(table):
    run = {"frame_ms": [280.0, 281.0, 282.0]}
    assert read("host_syncs_per_frame", run) == 42
    assert read("host_wait_ms_per_frame", run) == pytest.approx(80.0)
    assert read("rng_host_ms_per_frame", run) == pytest.approx(120.0)
    assert read("shade_host_ms_per_frame", run) == pytest.approx(45.0)
    assert read("trace_host_ms_per_frame", run) == pytest.approx(10.0)


def test_port_trace_takes_only_the_windows_frames(table):
    assert [s["step"] for s in port_trace.frames(
        {"frame_ms": [1.0, 2.0, 3.0]})] == [1, 2, 3]
    assert [s["step"] for s in port_trace.frames(
        {"frame_ms": [1.0]})] == [3]
    # More frames than recorded steps: nothing to read.
    assert port_trace.frames({"frame_ms": [1.0] * 5}) is None


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_without_summaries(monkeypatch, name):
    run = {"frame_ms": [280.0, 281.0]}
    monkeypatch.setattr(port_trace, "_port", None)     # a program without
    assert read(name, run) is None                     # spans
    monkeypatch.setattr(port_trace, "_port", FakePort([]))
    assert read(name, run) is None
    monkeypatch.setattr(port_trace, "_port", FakePort(TABLE))
    assert read(name, {"frame_ms": []}) is None


def test_a_traced_run_reports_the_five():
    r = _tiny.run_tiny("cornell_mesh6.progressive", trace=True)
    assert r["correct"]
    for name in NEW:
        assert name in r["metrics"], name
    assert r["metrics"]["host_syncs_per_frame"]["value"] == 42
    assert r["metrics"]["host_syncs_per_frame"]["unit"] == "syncs"
