"""The progressive loop counts ``attempted`` and ``failed`` on a snapshot
of the checked pixels at ``check_spp`` samples, so the count does not
depend on how many frames the window held (CPU, the tiny cell)."""

import pytest
import torch

from ptbench import check
from ptbench.tests import _tiny

CELL = "cornell_mesh6.progressive"


def _checked(sums):
    side = _tiny.overrides()["width"]
    pix = check.sample_pixels(_tiny.SEED, side * side,
                              _tiny.traffic_overrides(CELL)["check_pixels"])
    return sums.reshape(-1, 3)[torch.as_tensor(pix)]


@pytest.fixture(scope="module")
def two_windows():
    """One seed twice: a window of no seconds, which ends at the snapshot
    frame, and one that holds twice the samples or more. Each frame's sums
    are kept."""
    from pathtracing_tpu_torch.models import progressive

    sums = {}
    real = progressive.render_step

    def step(*args, **kwargs):
        state = real(*args, **kwargs)
        sums[state.spp] = state.accum.clone()
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(progressive, "render_step", step)
        seen = _tiny.recording_answers(mp)
        short = _tiny.run_tiny(CELL, seconds=0.0)
        first = seen[-1]
        snap = sums[_tiny.CHECK_SPP]
        long, second = _tiny.run_until(CELL, seen, 2 * first["spp"])
    return {"short": (short, first), "long": (long, second), "snap": snap}


def test_the_snapshot_holds_check_spp_samples_of_that_frame(two_windows):
    for res, a in (two_windows["short"], two_windows["long"]):
        assert res["correct"], res["compared"]
        assert a["snapshot_spp"] == _tiny.CHECK_SPP
        assert torch.equal(a["snapshot"], _checked(two_windows["snap"]))
    res, a = two_windows["long"]
    assert not torch.equal(a["snapshot"], _checked(a["accum"]))


def test_a_longer_window_counts_the_same_failures(two_windows):
    short, first = two_windows["short"]
    long, second = two_windows["long"]
    assert first["spp"] == _tiny.CHECK_SPP
    assert second["spp"] >= 2 * first["spp"]
    assert (short["attempted"], short["failed"]) == (long["attempted"],
                                                     long["failed"])
    assert (short["compared"]["snapshot_off_share"]
            == long["compared"]["snapshot_off_share"])


def test_a_short_window_runs_on_until_the_snapshot(monkeypatch):
    seen = _tiny.recording_answers(monkeypatch)
    want = _tiny.CHECK_SPP + 2
    res = _tiny.run_tiny(CELL, seconds=0.0, traffic={"check_spp": want})
    assert res["correct"], res["compared"]
    assert seen[-1]["spp"] == seen[-1]["snapshot_spp"] == want
