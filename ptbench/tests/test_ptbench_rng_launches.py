"""The reader of ``rng_launches_per_frame`` (the port's ``rng.launch``
spans a frame) on a fixed table of step summaries, and in small traced
runs of a cell on the CPU: the plain generator launches nothing, so the
line leaves the metric out; a generator that opens the span reports it
(``python -m pytest ptbench/tests``)."""

import functools

import pytest

from ptbench import port_trace, spec
from ptbench.tests import _tiny

NAME = "rng_launches_per_frame"


def read(run):
    return spec.metric_module(NAME).read(run)


def _summary(step, launches):
    spans = {"shade.rng": {"count": 44, "total_ns": 9, "self_ns": 5}}
    if launches is not None:
        spans["rng.launch"] = {"count": launches, "total_ns": 4,
                               "self_ns": 4}
    return {"step": step, "start_ns": 0, "end_ns": 1, "host_syncs": 1,
            "host_wait_ns": 0, "spans": spans}


class FakePort:
    def __init__(self, table):
        self.table = table

    def steps(self):
        return list(self.table)


def test_reads_the_median_launches_of_the_windows_frames(monkeypatch):
    # Set-up's warm frame (far off), then three window frames.
    table = [_summary(0, 900), _summary(1, 44), _summary(2, 46),
             _summary(3, 44)]
    monkeypatch.setattr(port_trace, "_port", FakePort(table))
    assert read({"frame_ms": [1.0, 2.0, 3.0]}) == 44
    assert read({"frame_ms": [1.0, 2.0]}) == 45


@pytest.mark.parametrize("table", [
    None,                                       # a program without spans
    [],                                         # no steps recorded
    [_summary(i, None) for i in range(4)],      # no rng.launch span
], ids=["no_spans", "no_steps", "no_launch_span"])
def test_reads_nothing_without_launches(monkeypatch, table):
    monkeypatch.setattr(port_trace, "_port",
                        None if table is None else FakePort(table))
    assert read({"frame_ms": [1.0, 2.0]}) is None


def test_the_plain_generator_leaves_it_out():
    r = _tiny.run_tiny("cornell_mesh6.progressive", trace=True)
    assert r["correct"]
    assert NAME not in r["metrics"]
    assert r["metrics"]["host_syncs_per_frame"]["value"] == 42


def test_a_generator_that_launches_reports_it(monkeypatch):
    """Each ``uniform`` call opens one ``rng.launch`` span, as a launch
    would on the card: the line reports the calls a frame."""
    from pathtracing_tpu_torch.ops import rng
    from pathtracing_tpu_torch.utils import metrics

    calls = []
    real = rng.uniform

    @functools.wraps(real)
    def uniform(*args, **kwargs):
        with metrics.span("rng.launch"):
            calls.append(1)
            return real(*args, **kwargs)

    monkeypatch.setattr(rng, "uniform", uniform)
    r = _tiny.run_tiny("cornell_mesh6.progressive", trace=True)
    assert r["correct"] and calls
    value = r["metrics"][NAME]["value"]
    assert r["metrics"][NAME]["unit"] == "launches"
    assert value == int(value) and 0 < value < len(calls)
