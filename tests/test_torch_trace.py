"""The engine's spans and host-sync counter (``utils/metrics.py``).

Off, a span is one shared no-op and nothing is recorded; on, a render
step's image is the same bit for bit. Synthetic spans on a fake clock
check self time, nesting, same-name re-entry, step ids and the rings.
Completeness: during one small ``render_step`` of the megakernel, the
wavefront and a volume scene, every host read the port's render path
makes (``torch.tensor``, ``torch.nonzero``, ``int``/``float``/``bool``/
``item``/``tolist`` of a tensor, a boolean-mask index, a Python scalar
set at tensor indices: each a stream synchronise on a CUDA device) is
made inside ``metrics.host_read``, and the counter equals their number
(42 for the benchmark's Cornell configuration at 32x18, 2 subdivisions,
as on the card at 1080p). The plain traversal routes (the ``*_torch``
functions of ``ops/cluster_trace.py``) stand in for the kernels on the
CPU and are exempt. ``ranges=True`` puts ``pt::`` ranges into a
profile and the CLI's ``--profile`` trace; the idle-by-span join is
checked on a synthetic event list; the step log counts the engine's
rays.
"""

import json
import logging
import os
import sys

import pytest
import torch

import pathtracing_tpu_torch
from pathtracing_tpu_torch import render
from pathtracing_tpu_torch.models import progressive, scenes, wavefront
from pathtracing_tpu_torch.ops import cluster_trace
from pathtracing_tpu_torch.ops.camera import build_camera
from pathtracing_tpu_torch.utils import logging as ptlog
from pathtracing_tpu_torch.utils import metrics
from pathtracing_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(2)

PORT = os.path.dirname(os.path.abspath(pathtracing_tpu_torch.__file__))
TORCH = os.path.dirname(os.path.abspath(torch.__file__))
METRICS = os.path.abspath(metrics.__file__)
PLAIN = os.path.abspath(cluster_trace.__file__)


@pytest.fixture(autouse=True)
def fresh():
    metrics.disable()
    metrics.reset()
    yield
    metrics.disable()
    metrics.reset()


def _render(name, engine="megakernel", size=(32, 18)):
    """(state after one step, the step's scene, camera and config)."""
    if name == "cornell_mesh":
        scene, cam = scenes.cornell_mesh(2, device="cpu")
    else:
        scene, cam = scenes.SCENES[name](device="cpu")
    w, h = size
    camera = build_camera(cam, w / h, device="cpu")
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=4,
                       samples_per_step=1, seed=2**33 + 5, engine=engine)
    return scene, camera, cfg


def _step(scene, camera, cfg, state=None):
    step = (wavefront.render_step if cfg.engine == "wavefront"
            else progressive.render_step)
    state = state or progressive.init_state(cfg, device="cpu")
    return step(state, scene, camera, cfg)


def test_off_records_nothing():
    assert metrics.span("engine.bounce") is metrics.span("shade.rng")
    assert metrics.step() is metrics.span("x")
    assert metrics.host_read("s", int, torch.tensor(3)) == 3
    _step(*_render("cornell_mesh", size=(8, 6)))
    assert metrics.steps() == [] and metrics.records() == []


@pytest.mark.parametrize("engine", ["megakernel", "wavefront"])
def test_tracing_leaves_the_image_bit_identical(engine):
    scene, camera, cfg = _render("cornell_mesh", engine)
    off = _step(scene, camera, cfg)
    metrics.enable()
    on = _step(scene, camera, cfg)
    metrics.disable()
    assert torch.equal(off.accum, on.accum)
    (s,) = metrics.steps()
    assert s["spans"]["engine.step"]["count"] == 1
    assert s["spans"]["engine.bounce"]["count"] == (
        8 if engine == "megakernel" else s["spans"]["sync.wavefront.live"][
            "count"])


@pytest.fixture
def clock(monkeypatch):
    """time.time_ns stepping by 10 ns a read."""
    now = [0]

    def tick():
        now[0] += 10
        return now[0]

    monkeypatch.setattr(metrics.time, "time_ns", tick)
    return now


def test_self_time_and_nesting(clock):
    metrics.enable()
    with metrics.step():                    # 10 .. 80
        with metrics.span("a"):             # 20 .. 70
            with metrics.span("b"):         # 30 .. 40
                pass
            metrics.host_read("site", int, torch.tensor(1))  # 50 .. 60
    (s,) = metrics.steps()
    assert s["spans"]["engine.step"] == {"count": 1, "total_ns": 70,
                                         "self_ns": 20}
    assert s["spans"]["a"] == {"count": 1, "total_ns": 50, "self_ns": 30}
    assert s["spans"]["b"] == {"count": 1, "total_ns": 10, "self_ns": 10}
    assert s["host_syncs"] == 1 and s["host_wait_ns"] == 10
    got = {(r.name, r.parent, r.start_ns, r.end_ns)
           for r in metrics.records()}
    assert got == {("engine.step", None, 10, 80), ("a", "engine.step", 20, 70),
                   ("b", "a", 30, 40), ("sync.site", "a", 50, 60)}


def test_same_name_reentry_is_recorded_once(clock):
    metrics.enable()
    with metrics.step():
        with metrics.span("shade.rng"):
            with metrics.span("other"):
                with metrics.span("shade.rng"):
                    pass
        with metrics.step():                # a nested step opens none
            pass
    (s,) = metrics.steps()
    assert s["spans"]["shade.rng"]["count"] == 1
    assert s["spans"]["engine.step"]["count"] == 1
    assert [r.name for r in metrics.records()].count("shade.rng") == 1


def test_step_ids_and_what_lies_outside_a_step(clock):
    metrics.enable()
    with metrics.span("loose"):
        assert metrics.host_read("s", int, torch.tensor(1)) == 1
    for _ in range(3):
        with metrics.step():
            metrics.host_read("s", float, torch.tensor(2.0), syncs=2)
    assert [s["step"] for s in metrics.steps()] == [0, 1, 2]
    assert [s["host_syncs"] for s in metrics.steps()] == [2, 2, 2]
    assert {r.step for r in metrics.records()} == {0, 1, 2}
    assert "loose" not in {r.name for r in metrics.records()}


def test_rings_keep_the_last_steps(clock, monkeypatch):
    monkeypatch.setattr(metrics, "STEP_RING", 5)
    monkeypatch.setattr(metrics, "RAW_STEPS", 2)
    metrics.reset()
    metrics.enable()
    for _ in range(8):
        with metrics.step():
            with metrics.span("a"):
                pass
    assert [s["step"] for s in metrics.steps()] == [3, 4, 5, 6, 7]
    assert sorted({r.step for r in metrics.records()}) == [6, 7]
    assert len(metrics.records()) == 4


# --- Completeness of the host-sync counter ----------------------------------


class Reads:
    """Counts each synchronising call the port makes, as counted (inside
    ``host_read``), exempt (the plain traversal routes) or uncounted."""

    def __init__(self):
        self.counted, self.exempt, self.uncounted = 0, 0, []

    def saw(self):
        f = sys._getframe(2)
        while f is not None and os.path.abspath(
                f.f_code.co_filename).startswith(TORCH):
            f = f.f_back
        if f is None or not os.path.abspath(
                f.f_code.co_filename).startswith(PORT):
            return
        where = f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
        while f is not None:
            path = os.path.abspath(f.f_code.co_filename)
            if path == METRICS and f.f_code.co_name in ("host_read",
                                                        "to_device"):
                self.counted += 1
                return
            if path == PLAIN and f.f_code.co_name.endswith("_torch"):
                self.exempt += 1
                return
            f = f.f_back
        self.uncounted.append(where)


def _has_mask(index):
    items = index if isinstance(index, tuple) else (index,)
    return any(torch.is_tensor(i) and i.dtype == torch.bool and i.dim() > 0
               for i in items)


def _has_tensor(index):
    items = index if isinstance(index, tuple) else (index,)
    return any(torch.is_tensor(i) for i in items)


@pytest.fixture
def reads(monkeypatch):
    seen = Reads()

    def wrap(owner, name, when=None):
        real = getattr(owner, name)

        def inner(*a, **k):
            if when is None or when(*a, **k):
                seen.saw()
            return real(*a, **k)

        monkeypatch.setattr(owner, name, inner)

    seen.install = lambda: (
        wrap(torch, "tensor"), wrap(torch, "nonzero"),
        [wrap(torch.Tensor, n) for n in (
            "__int__", "__float__", "__bool__", "__index__", "item",
            "tolist", "nonzero", "cpu", "numpy")],
        wrap(torch.Tensor, "__getitem__", lambda x, i: _has_mask(i)),
        wrap(torch.Tensor, "__setitem__", lambda x, i, v: _has_mask(i) or (
            _has_tensor(i) and isinstance(v, (bool, int, float)))))
    return seen


@pytest.mark.parametrize("name,engine,size,want", [
    ("cornell_mesh", "megakernel", (32, 18), 42),
    ("cornell_mesh", "wavefront", (16, 12), None),
    ("smoke_demo", "megakernel", (12, 12), None),
])
def test_every_blocking_read_goes_through_host_read(reads, name, engine,
                                                    size, want):
    scene, camera, cfg = _render(name, engine, size)
    state = progressive.init_state(cfg, device="cpu")
    metrics.enable()
    reads.install()
    _step(scene, camera, cfg, state)
    (s,) = metrics.steps()
    assert reads.uncounted == []
    assert s["host_syncs"] == reads.counted
    if want is not None:
        assert s["host_syncs"] == want
    assert s["host_syncs"] > 0 and s["host_wait_ns"] > 0


# --- Profiler ranges, the CLI and the join ------------------------------------


def test_ranges_enter_a_cpu_profile():
    scene, camera, cfg = _render("cornell_mesh", size=(8, 6))
    metrics.enable(ranges=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _step(scene, camera, cfg)
    names = {e.key for e in prof.key_averages()}
    assert {"pt::engine.step", "pt::engine.bounce", "pt::shade.rng",
            "pt::trace.closest", "pt::sync.rng.words"} <= names


@pytest.fixture
def said():
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Keep()
    ptlog.get_logger().addHandler(handler)
    yield lines
    ptlog.get_logger().removeHandler(handler)


def test_profile_writes_port_ranges(tmp_path, said):
    prof = str(tmp_path / "prof")
    assert render.main(["--device", "cpu", "--scene", "cornell_sphere",
                        "--width", "16", "--height", "16", "--max-depth",
                        "3", "--spp", "2", "--spp-per-step", "1",
                        "--profile", prof,
                        "--out", str(tmp_path / "p.png")]) == 0
    with open(os.path.join(prof, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"pt::engine.step", "pt::engine.bounce", "pt::shade.rng"} <= names
    assert any(s.startswith("profiled steps: 2; host syncs a step")
               for s in said)
    assert any(s.startswith("device idle ms by port span") for s in said)
    assert metrics.steps() and metrics._tracer is None


class Ev:
    """A kineto event of the profile's table."""

    def __init__(self, name, start, end, device="cuda", annotation=False):
        from torch.autograd import DeviceType

        self._n, self._a, self._b, self._ann = name, start, end, annotation
        self._d = DeviceType.CUDA if device == "cuda" else DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return self._d

    def is_hidden_event(self):
        return False

    def is_user_annotation(self):
        return self._ann


def test_idle_by_span_on_synthetic_events():
    rec = metrics.SpanRecord
    records = [rec("engine.step", None, 0, 0, 100_000_000),
               rec("shade.rng", "engine.step", 0, 10_000_000, 30_000_000),
               rec("sync.rng.words", "shade.rng", 0, 20_000_000, 25_000_000),
               rec("trace.closest", "engine.step", 0, 50_000_000,
                   60_000_000)]
    events = [
        Ev("kernel", 0, 15_000_000),
        Ev("kernel", 22_000_000, 40_000_000),
        Ev("kernel", 55_000_000, 70_000_000),
        # Not device ops: the host's launch, a range's device-side
        # annotation, the port's own range.
        Ev("cudaLaunchKernel", 30_000_000, 90_000_000, device="cpu"),
        Ev("pt::engine.step", 0, 100_000_000, annotation=True),
        Ev("pt::trace.closest", 50_000_000, 60_000_000),
    ]
    got = metrics.idle_by_span(events, records)
    # Idle: 15-22 (rng 15-20, sync 20-22), 40-55 (step 40-50, trace
    # 50-55), 70-100 (step).
    assert got == pytest.approx({"engine.step": 40.0, "shade.rng": 5.0,
                                 "sync.rng.words": 2.0,
                                 "trace.closest": 5.0})
    assert list(got)[0] == "engine.step"
    wide = metrics.idle_by_span(events, records,
                                window=(-10_000_000, 110_000_000))
    assert wide["no span"] == pytest.approx(20.0)
    assert metrics.idle_by_span(events, []) == {}


def test_step_log_counts_the_engines_rays():
    cfg = RenderConfig(width=4, height=2, samples_per_step=1, max_depth=8)
    m = render._step_metrics(cfg, 1, 1, 2.0, {
        "segments": torch.tensor(30), "shadow_segments": torch.tensor(10)})
    assert m.mrays_per_s == pytest.approx(40 / 2.0 / 1e6)
    bound = render._step_metrics(cfg, 1, 1, 2.0)
    assert bound.mrays_per_s == pytest.approx(
        metrics.rays_per_sample(4, 2, 8) / 2.0 / 1e6)
