"""The wavefront cell (``loops/wavefront.py``, parked) on the CPU: its frames
are the megakernel's, bit for bit, so its snapshot of the checked pixels
equals the progressive cell's from the same seed; a traced run reports
``pool_occupancy``, whose reader reads nothing where the engine counts no
slots."""

import torch

from ptbench import spec
from ptbench.tests import _tiny

WAVEFRONT = "cornell_mesh6.wavefront"


def read(run):
    return spec.metric_module("pool_occupancy").read(run)


def test_pool_occupancy_reads_live_slots_over_slots():
    assert read({"counts": {"segments": 300, "shadow_segments": 9,
                            "slots": 400}}) == 75.0
    # The megakernel counts segments, no slots; an untraced run nothing.
    assert read({"counts": {"segments": 300, "shadow_segments": 9}}) is None
    assert read({"counts": None}) is None


def test_the_wavefront_snapshot_equals_the_megakernels(monkeypatch):
    seen = _tiny.recording_answers(monkeypatch)
    for cell in ("cornell_mesh6.progressive", WAVEFRONT):
        res = _tiny.run_tiny(cell, seconds=0.0)
        assert res["correct"], res["compared"]
    mega, wave = seen[0], seen[-1]
    assert mega["snapshot_spp"] == wave["snapshot_spp"] == _tiny.CHECK_SPP
    assert torch.equal(mega["snapshot"], wave["snapshot"])


def test_a_traced_wavefront_run_reports_the_pool():
    res = _tiny.run_tiny(WAVEFRONT, trace=True)
    assert res["correct"], res["compared"]
    occupancy = res["metrics"]["pool_occupancy"]["value"]
    assert 0.0 < occupancy <= 100.0
    bench = _tiny.with_parked(spec.load())
    want = {m["name"] for m in spec.metrics_of(bench, WAVEFRONT, "per_layer")}
    # What the CPU cannot read: the profile (no device ops recorded) and
    # the generator's kernel launches.
    assert want - set(res["metrics"]) <= {
        "device_ops_per_msample", "shade_ms_per_msample",
        "trace_ms_per_msample", "trace_roofline", "device_idle_share",
        "rng_launches_per_frame"}
