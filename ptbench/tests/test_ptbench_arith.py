"""The benchmark's frozen arithmetic on hand-made counts and a fixed
profiler table, and a run without a card (CPU)."""

import os
import subprocess
import sys

import pytest
from torch.autograd import DeviceType

from ptbench import profiling, roofline, spec


def read(name, run):
    return spec.metric_module(name).read(run)


def test_msamples_per_s_is_all_samples_over_the_whole_window():
    run = {"samples": 37 * 1920 * 1080, "window_s": 10.25}
    assert read("msamples_per_s", run) == pytest.approx(
        37 * 2.0736 / 10.25)


def test_frame_tail_is_over_all_frames():
    # 100 frames: 90 at 250 ms and 10 slow ones; medians of chunks of ten
    # would read 250 everywhere.
    frames = [250.0] * 90 + [400.0 + i for i in range(10)]
    frames = frames[::2] + frames[1::2]
    run = {"frame_ms": frames}
    # Linear interpolation at rank 0.9 * 99 = 89.1 of the sorted frames.
    assert read("frame_ms.p90", run) == pytest.approx(250.0 + 0.1 * 150.0)
    assert read("frame_ms.p90", {"frame_ms": []}) is None


def test_trace_roofline_bytes_and_operations():
    # 10 M closest-hit and 4 M shadow rays in 16 launches over 81,932
    # triangles: bytes 10e6*52 + 4e6*29 + 16*81,932*36 = 683,192,832.
    least = roofline.least_seconds(10_000_000, 4_000_000, 16, 81_932)
    assert least["bytes_s"] == pytest.approx(683_192_832 / 3.35e12)
    assert least["flops_s"] == pytest.approx(14e6 * 48 / 67e12)
    assert least["bound"] == "bytes"
    run = {"triangles": 81_932, "profile": {
        "counts": {"segments": 10_000_000, "shadow_segments": 4_000_000},
        "traversal": {"s": 0.0102, "launches": 16}}}
    assert read("trace_roofline", run) == pytest.approx(
        100 * 683_192_832 / 3.35e12 / 0.0102)
    # Few rays over a huge scene: still bytes; one ray, no triangles:
    # the test's operations.
    assert roofline.least_seconds(1, 0, 1, 0)["bound"] == "bytes"
    assert roofline.least_seconds(10**9, 0, 1, 0)["flops_s"] == \
        pytest.approx(48e9 / 67e12)


class _Ev:
    def __init__(self, name, dev, a, b, cid=0, link=0):
        self._n, self._d, self._a, self._b = name, dev, a, b
        self._c, self._l = cid, link

    def is_hidden_event(self):
        return False

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l


def _table():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    ms = 1_000_000
    events = [
        _Ev("ptbench::render", cpu, 0, 60 * ms),
        _Ev("aten::mul", cpu, 1 * ms, 2 * ms, cid=1),
        _Ev("cudaLaunchKernel", cpu, 3 * ms, 4 * ms, cid=2),
        _Ev("aten::item", cpu, 32 * ms, 58 * ms, cid=3),
        _Ev("ptbench::present", cpu, 70 * ms, 90 * ms),
        _Ev("aten::div", cpu, 71 * ms, 72 * ms, cid=4),
        _Ev("elementwise_kernel", cuda, 10 * ms, 20 * ms, link=1),
        _Ev("void trace_dnf_kernel<false>(float*)", cuda, 15 * ms, 30 * ms,
            link=2),
        _Ev("reduce_kernel", cuda, 40 * ms, 45 * ms, link=3),
        _Ev("div_kernel", cuda, 75 * ms, 76 * ms, link=4),
    ]
    return profiling.reduce_events(events, window_s=0.1)


def test_profiler_table_busy_spans_and_gaps():
    t = _table()
    # Union of device intervals: [10, 30] + [40, 45] + [75, 76] ms.
    assert t["busy_s"] == pytest.approx(0.026)
    assert t["device_ops"] == 4
    assert t["traversal"] == {"s": pytest.approx(0.015), "launches": 1}
    assert t["by_span"]["present"] == pytest.approx(0.001)
    assert t["by_span"]["render"] == pytest.approx(0.030)
    # The longest idle gap, 45 -> 75 ms, is named by the host op across
    # its middle (60 ms: none but the spans, which are not host ops).
    assert t["idle_gaps"][0][1] == pytest.approx(0.030)
    assert t["idle_gaps"][1] == ["aten::item", pytest.approx(0.010)]


def test_device_idle_share_and_per_sample_readers():
    t = _table()
    t["samples"] = 2_000_000
    run = {"profile": t}
    assert read("device_idle_share", run) == pytest.approx(74.0)
    assert read("device_ops_per_msample", run) == pytest.approx(2.0)
    assert read("trace_ms_per_msample", run) == pytest.approx(7.5)
    # Device time 31 ms, less 15 of traversal and 1 of present.
    assert read("shade_ms_per_msample", run) == pytest.approx(7.5)
    assert read("device_idle_share", {"profile": None}) is None


def test_round_ms_is_the_median_greedy_round():
    assert read("round_ms.adaptive", {"round_ms": [300.0, 354.0, 310.0]}) \
        == 310.0
    assert read("round_ms.adaptive", {"round_ms": []}) is None


def test_segments_per_sample_from_the_engine_counts():
    run = {"counts": {"segments": 1200, "shadow_segments": 300,
                      "samples": 100}}
    assert read("segments_per_sample", run) == 15.0
    assert read("segments_per_sample", {"counts": None}) is None


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "ptbench.run", "--workload",
         "cornell_mesh6.progressive", "--seed", str(2**33 + 5), "--seconds",
         "1", "--trace", "0"], cwd=spec.ROOT, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
