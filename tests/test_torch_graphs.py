"""A block wave's two segments (``megakernel.segment_a`` and
``segment_b``) and their CUDA graphs (``models.graphs``).

On the CPU the segments run eagerly: segment B on the live prefix of the
compaction's permutation rounded up to a bucket, padded with dead lanes,
scattered back over the radiance at the compaction, equals the op-by-op
wave (``megakernel._trace_pixels``, segment B at the live count) bit for
bit, with the same ``stats``, on the flat, paged and two-level routes,
for buckets that pad 0, 1 and every dead lane. A host read inside a
capture raises before it reads; the CPU renders take no graphs. With a
stand-in for the capture, the wave cache replays, keeps to its bounds,
and captures no key of an orbit after the first.

On the card (tests marked ``card``; they skip without one) replayed
frames equal frames issued op by op bit for bit, with equal ``stats``
and kernel launches, across bucket changes; a scene whose bounce reads
the host (the voxel grid) stays op by op. The suite's ``conftest.py``
imports JAX, which the machine with the card lacks, so run them there
with

    python -m pytest tests/test_torch_graphs.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from pathtracing_tpu_torch.models import graphs, megakernel, progressive
from pathtracing_tpu_torch.models import scene as scene_mod
from pathtracing_tpu_torch.models import scenes
from pathtracing_tpu_torch.ops import cluster_trace as ct
from pathtracing_tpu_torch.ops import pgather, rng
from pathtracing_tpu_torch.ops.camera import build_camera
from pathtracing_tpu_torch.utils import metrics
from pathtracing_tpu_torch.utils.config import CameraConfig, RenderConfig

torch.set_num_threads(2)

FIELD_CAMERA = CameraConfig(position=(0.0, 5.0, 7.0), look_at=(0.0, 0.0, 0.0),
                            vfov_degrees=50.0)


def _field(device, grid=3):
    """A ground, a light and a ``grid``² field of one 80-triangle
    icosphere, every third placement with its own material."""
    b = scene_mod.SceneBuilder()
    body = b.lambertian((0.7, 0.3, 0.25))
    rust = b.lambertian((0.8, 0.6, 0.3))
    ground = b.lambertian((0.6, 0.58, 0.52))
    light = b.emissive((40.0, 38.0, 34.0))
    b.add_quad((-6.0, 0.0, -6.0), (12.0, 0.0, 0.0), (0.0, 0.0, 12.0), ground)
    b.add_quad((-1.0, 5.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), light)
    rs = np.random.default_rng(grid)
    ts, mats = [], []
    half = 0.75 * (grid - 1)
    for i in range(grid):
        for j in range(grid):
            a = rs.uniform(0.0, 2.0 * np.pi)
            c, s = np.cos(a), np.sin(a)
            rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
            t = np.array([-half + 1.5 * i, 0.45, -half + 1.5 * j])
            ts.append(np.concatenate([rot, t[:, None]], axis=1))
            mats.append(rust if (i * grid + j) % 3 == 0 else None)
    verts, faces = scenes.icosphere(1, 0.45)
    b.add_instances(verts, faces, body, ts, materials=mats)
    return b.build(device)


def _build(route, device):
    """(scene, camera config, clamp) of a tiny scene on ``route``."""
    if route == "flat":
        return (scenes.cornell_mesh_builder(2).build(device),
                scenes.CORNELL_CAMERA, 0.0)
    if route == "paged":
        scene = scenes.cornell_mesh_builder(2).build(device, page_clusters=2)
        assert scene.pages is not None
        return scene, scenes.CORNELL_CAMERA, 0.0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ct, "DNF_MAX_CLUSTERS", 4)
        scene = _field(device)
    assert scene.inst_tree is not None
    return scene, FIELD_CAMERA, 4.0


ROUTES = ("flat", "paged", "inst_tree")


@pytest.fixture(autouse=True)
def _keep_tracing(monkeypatch):
    """A test's turning spans on or off ends with it (a module of the
    suite may have turned them on for good)."""
    monkeypatch.setattr(metrics, "_tracer", metrics._tracer)


@pytest.fixture(scope="module")
def built():
    return {route: _build(route, "cpu") for route in ROUTES}


def _bits(x):
    return x.contiguous().view(torch.int32)


def _counts(stats):
    return {k: int(v) for k, v in (stats or {}).items()}


@pytest.mark.parametrize("take_stats", [False, True], ids=["plain", "stats"])
@pytest.mark.parametrize("pad", ["none", "one", "all"])
@pytest.mark.parametrize("route", ROUTES)
def test_segments_equal_the_wave_op_by_op(built, monkeypatch, route, pad,
                                          take_stats):
    scene, cam_cfg, clamp = built[route]
    w, h = 14, 10
    config = RenderConfig(width=w, height=h, max_depth=8, seed=3,
                          clamp=clamp)
    camera = build_camera(cam_cfg, w / h, device="cpu")
    traversal = config.resolve_traversal(scene)
    assert megakernel.compact_depth(scene, config, traversal) == 3
    assert not megakernel._replays(scene, config, traversal)
    pixels = megakernel._block_pixels(0, h, w, "cpu")
    sample = 5

    want_stats = {} if take_stats else None
    want = megakernel._trace_pixels(scene, camera, config, traversal, pixels,
                                    sample, 17, want_stats)

    a = megakernel.segment_a(scene, camera, config, traversal, pixels,
                             sample, 17, take_stats)
    n, n_live = pixels.shape[0], int(a.n_live)
    assert 0 < n_live < n - 1
    quantum = {"none": 1, "one": n_live + 1, "all": n}[pad]
    monkeypatch.setattr(megakernel, "GRAPH_BUCKET", quantum)
    lanes = megakernel.bucket(n_live, n)
    assert lanes - n_live == {"none": 0, "one": 1, "all": n - n_live}[pad]
    got, tally_b = megakernel.segment_b(scene, config, traversal, a, lanes,
                                        take_stats)
    assert torch.equal(_bits(got), _bits(want))
    assert float(got.sum()) > 0.0
    if not take_stats:
        assert a.tally is None and tally_b is None
        return
    got_stats = {}
    for tally in (a.tally, tally_b):
        for k, v in tally.items():
            got_stats[k] = got_stats.get(k, 0) + v
    assert _counts(got_stats) == _counts(want_stats)
    assert _counts(want_stats)["shadow_segments"] > 0
    if route == "inst_tree":
        assert set(want_stats) >= set(ct.WALK_COUNTS)


def test_bucket_rounds_up_within_the_wave(monkeypatch):
    monkeypatch.setattr(megakernel, "GRAPH_BUCKET", 16)
    assert megakernel.bucket(0, 100) == 0
    assert megakernel.bucket(1, 100) == 16
    assert megakernel.bucket(16, 100) == 16
    assert megakernel.bucket(17, 100) == 32
    assert megakernel.bucket(97, 100) == 100


def test_a_host_read_inside_a_capture_raises_before_reading():
    reads = []

    def read():
        reads.append(1)
        return 7

    for on in (False, True):
        if on:
            metrics.enable()
        try:
            with metrics.capturing():
                with pytest.raises(metrics.CaptureUnsafe):
                    metrics.host_read("test", read)
                with pytest.raises(metrics.CaptureUnsafe):
                    metrics.to_device("test", 1, torch.int64, "cpu")
            assert metrics.host_read("test", read) == 7
        finally:
            metrics.disable()
    assert reads == [1, 1]


def test_a_capture_records_no_span_and_a_replay_adds_its_counts():
    """Spans opened inside a capture are not recorded (the capture's own
    is); ``add_spans`` counts spans of no time in the open step only."""
    metrics.reset()
    metrics.enable()
    try:
        metrics.add_spans("rng.launch", 3)           # outside a step
        with metrics.step():
            with metrics.span(graphs.CAPTURE_SPAN), metrics.capturing():
                with metrics.span("rng.launch"):
                    pass
            with metrics.span("rng.launch"):
                pass
            metrics.add_spans("rng.launch", 44)
    finally:
        metrics.disable()
    (summary,) = metrics.steps()
    assert summary["spans"]["rng.launch"]["count"] == 45
    assert summary["spans"][graphs.CAPTURE_SPAN]["count"] == 1
    assert len([r for r in metrics.records()
                if r.name == "rng.launch"]) == 1


def test_cpu_renders_take_no_graphs(built):
    scene, cam_cfg, _ = built["flat"]
    config = RenderConfig(width=8, height=6, samples_per_step=1)
    camera = build_camera(cam_cfg, 8 / 6, device="cpu")
    megakernel.clear_graphs()
    state = progressive.init_state(config, device="cpu")
    progressive.render_step(state, scene, camera, config)
    assert not megakernel._WAVES


def _copy_into(dst, src):
    """``src``'s tensors copied into ``dst``'s, in place (a graph's static
    outputs rewritten by a replay)."""
    if torch.is_tensor(dst):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_into(d, s)


class _StandIn(graphs.Graph):
    """A stand-in for a captured graph on the CPU: a replay runs the
    segment again and writes its outputs over the first run's."""

    def __init__(self, fn):
        super().__init__(None, fn(), {})
        self.fn = fn

    def replay(self):
        with metrics.span(graphs.REPLAY_SPAN):
            _copy_into(self.out, self.fn())
        return self.out


def test_the_wave_cache_replays_segments_and_equals_op_by_op(built,
                                                            monkeypatch):
    """The engine's graph path on the CPU with a stand-in for the capture:
    a key's first wave runs op by op and is captured, later waves replay
    segment A, read the live count and replay segment B at its bucket (a
    new bucket runs op by op, then is captured). Every frame's sum and the
    ``stats`` equal the frames without graphs."""
    scene, cam_cfg, _ = built["inst_tree"]
    config = RenderConfig(width=14, height=10, max_depth=8, seed=6,
                          samples_per_step=1)
    camera = build_camera(cam_cfg, 1.4, device="cpu")

    def frames(n, stats):
        state = progressive.init_state(config, device="cpu")
        out = []
        for _ in range(n):
            state = progressive.render_step(state, scene, camera, config,
                                            stats=stats)
            out.append(state.accum.clone())
        return out

    want_stats = {}
    want = frames(6, want_stats)
    megakernel.clear_graphs()
    monkeypatch.setattr(megakernel, "GRAPH_BUCKET", 4)
    monkeypatch.setattr(megakernel, "_replays", lambda *a: True)
    monkeypatch.setattr(megakernel, "GRAPH_BUCKETS", 64)
    monkeypatch.setattr(graphs, "capture",
                        lambda fn, dev, share=None: _StandIn(fn))
    got_stats = {}
    metrics.reset()
    metrics.enable()
    try:
        got = frames(6, got_stats)
    finally:
        metrics.disable()
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    assert _counts(got_stats) == _counts(want_stats)
    (wave,) = megakernel._WAVES.values()
    assert not wave.eager and wave.seen == 6 and wave.a is not None
    spans = [s["spans"] for s in metrics.steps()[-6:]]
    eager = [s.get(megakernel.SEGMENT_SPAN, {}).get("count", 0)
             for s in spans]
    replays = [s.get(graphs.REPLAY_SPAN, {}).get("count", 0) for s in spans]
    assert eager[0] == 2 and replays[0] == 0
    assert all(e + r == 2 for e, r in zip(eager, replays))
    # Op-by-op segments after the first frame are new buckets' segment B.
    assert sum(eager[1:]) == len(wave.b) - 1
    megakernel.clear_graphs()


def _stand_in_cache(monkeypatch):
    """The graph path on the CPU, each capture a ``_StandIn``, counted."""
    captures = []

    def capture(fn, dev, share=None):
        captures.append(fn)
        return _StandIn(fn)

    megakernel.clear_graphs()
    monkeypatch.setattr(megakernel, "_replays", lambda *a: True)
    monkeypatch.setattr(graphs, "capture", capture)
    return captures


def test_the_wave_cache_keeps_to_its_bounds(built, monkeypatch):
    """Waves past ``GRAPH_WAVES`` drop the least recently used, with its
    graphs; buckets past ``GRAPH_BUCKETS`` drop a wave's oldest."""
    scene, cam_cfg, _ = built["flat"]
    config = RenderConfig(width=14, height=10, max_depth=8, seed=6)
    camera = build_camera(cam_cfg, 1.4, device="cpu")
    _stand_in_cache(monkeypatch)
    monkeypatch.setattr(megakernel, "GRAPH_BUCKET", 1)
    monkeypatch.setattr(megakernel, "GRAPH_WAVES", 2)
    for row0 in (0, 3, 6):                  # a key a block of rows
        megakernel.render_samples(scene, camera, config, 0, 4, 5,
                                  row_start=row0, block_rows=3)
    assert [key[1] for key in megakernel._WAVES] == [3, 6]
    for wave in megakernel._WAVES.values():
        assert wave.seen == 4 and wave.a is not None
        assert 1 <= len(wave.b) <= megakernel.GRAPH_BUCKETS
    megakernel.clear_graphs()


def test_an_orbit_pays_for_one_capture(built, monkeypatch):
    """A new camera and seed every frame of two samples (the CLI's
    orbit): the first frame's key is captured; it was seen fewer than
    ``PAYBACK`` times, so later keys wait for ``PAYBACK`` sightings,
    which they never reach. A key after them is captured at its
    ``PAYBACK``-th sighting, and a key in an empty cache at its first;
    after a key seen ``PAYBACK`` times, a new one is captured at once."""
    scene, cam_cfg, _ = built["flat"]
    config = RenderConfig(width=14, height=10, max_depth=8, seed=6)
    captures = _stand_in_cache(monkeypatch)
    for i in range(5):
        camera = build_camera(cam_cfg, 1.4 + 0.01 * i, device="cpu")
        megakernel.render_samples(scene, camera, config, 0, 2, 100 + i)
    assert len(captures) == 2               # segments A and B of frame 0
    assert all(w.seen == 2 and w.a is None
               for w in list(megakernel._WAVES.values())[1:])
    camera = build_camera(cam_cfg, 1.4, device="cpu")
    megakernel.render_samples(scene, camera, config, 0,
                              megakernel.PAYBACK - 1, 7)
    wave = next(reversed(megakernel._WAVES.values()))
    assert wave.a is None and len(captures) == 2
    megakernel.render_samples(scene, camera, config, 0, 2, 7)
    assert wave.a is not None and len(captures) == 4
    megakernel.render_samples(scene, camera, config, 0, 1, 8)
    assert next(reversed(megakernel._WAVES.values())).a is not None
    megakernel.clear_graphs()
    megakernel.render_samples(scene, camera, config, 0, 1, 9)
    (wave,) = megakernel._WAVES.values()
    assert wave.a is not None
    megakernel.clear_graphs()


# --- On the card ------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: CUDA graphs and the CUDA kernels run only "
                    "on the card")
    megakernel.clear_graphs()
    yield torch.device("cuda")
    megakernel.clear_graphs()


def _launches():
    return {**ct.LAUNCHES, **pgather.LAUNCHES, **rng.LAUNCHES}


def _frames(scene, camera, config, n, replay, stats):
    """``n`` progressive frames from sample 0, replayed or op by op:
    (each frame's accumulator, the stats, the kernel launches)."""
    old = megakernel._replays
    if not replay:
        megakernel._replays = lambda *a: False
    try:
        ct.reset_launches()
        pgather.reset_launches()
        for name in rng.LAUNCHES:
            rng.LAUNCHES[name] = 0
        state = progressive.init_state(config, device=scene.tri_v0.device)
        accums = []
        for _ in range(n):
            state = progressive.render_step(state, scene, camera, config,
                                            stats=stats)
            accums.append(state.accum.clone())
        torch.cuda.synchronize()
        return accums, _counts(stats), _launches()
    finally:
        megakernel._replays = old


@pytest.mark.card
@pytest.mark.parametrize("take_stats", [False, True], ids=["plain", "stats"])
@pytest.mark.parametrize("route", ROUTES)
def test_replayed_frames_equal_frames_op_by_op(card, monkeypatch, route,
                                               take_stats):
    """Three frames (the sample index advancing): the first runs op by op
    and is captured, the next two replay. Their sums, ``stats`` and
    kernel launches equal the op-by-op frames', and so do the replayed
    frames' counts of ``rng.launch`` spans; the key never falls back to
    op by op."""
    monkeypatch.setattr(megakernel, "GRAPH_BUCKET", 256)
    scene, cam_cfg, clamp = _build(route, card)
    config = RenderConfig(width=96, height=64, max_depth=8, seed=9,
                          samples_per_step=1, clamp=clamp)
    camera = build_camera(cam_cfg, 96 / 64, device=card)

    def traced(replay):
        metrics.reset()
        metrics.enable()
        try:
            out = _frames(scene, camera, config, 3, replay,
                          {} if take_stats else None)
        finally:
            metrics.disable()
        return out, [s["spans"] for s in metrics.steps()[-3:]]

    want, want_spans = traced(False)
    got, spans = traced(True)
    for g, w in zip(got[0], want[0]):
        assert torch.equal(_bits(g), _bits(w))
    assert got[1] == want[1]
    assert got[2] == want[2] and sum(want[2].values()) > 0
    (wave,) = megakernel._WAVES.values()
    assert not wave.eager and wave.seen == 3 and wave.a is not None
    replays = [s.get(graphs.REPLAY_SPAN, {}).get("count", 0) for s in spans]
    assert replays[0] == 0 and min(replays[1:]) >= 1
    launches = [[s[rng.LAUNCH_SPAN]["count"] for s in ss[1:]]
                for ss in (spans, want_spans)]
    assert launches[0] == launches[1] and min(launches[1]) > 0


@pytest.mark.card
def test_a_new_bucket_mid_run_is_captured_and_still_equal(card,
                                                          monkeypatch):
    """Buckets of 8 lanes: the live count moves between buckets frame to
    frame, so new segment-B graphs are captured mid-run; every frame
    equals the op-by-op frame."""
    monkeypatch.setattr(megakernel, "GRAPH_BUCKET", 8)
    monkeypatch.setattr(megakernel, "GRAPH_BUCKETS", 64)
    scene, cam_cfg, clamp = _build("flat", card)
    config = RenderConfig(width=64, height=48, max_depth=8, seed=4,
                          samples_per_step=1)
    camera = build_camera(cam_cfg, 64 / 48, device=card)
    want = _frames(scene, camera, config, 6, False, {})
    got = _frames(scene, camera, config, 6, True, {})
    for g, w in zip(got[0], want[0]):
        assert torch.equal(_bits(g), _bits(w))
    assert got[1] == want[1] and got[2] == want[2]
    (wave,) = megakernel._WAVES.values()
    assert len(wave.b) >= 2 and not wave.eager


@pytest.mark.card
def test_a_scene_whose_bounce_reads_the_host_stays_op_by_op(card):
    """The voxel grid's lane reads (``ops.volume``) cannot be captured:
    the capture is thrown away and every frame runs op by op, with no
    ``engine.replay`` span, equal to the frames without graphs."""
    scene, cam_cfg = scenes.smoke_demo(device=card)
    config = RenderConfig(width=48, height=32, max_depth=5, seed=2,
                          samples_per_step=1)
    camera = build_camera(cam_cfg, 48 / 32, device=card)
    assert megakernel._replays(scene, config,
                               config.resolve_traversal(scene))
    want = _frames(scene, camera, config, 3, False, None)
    metrics.reset()
    metrics.enable()
    try:
        got = _frames(scene, camera, config, 3, True, None)
    finally:
        metrics.disable()
    for g, w in zip(got[0], want[0]):
        assert torch.equal(_bits(g), _bits(w))
    assert got[2] == want[2]
    steps = metrics.steps()[-3:]
    assert all(graphs.REPLAY_SPAN not in s["spans"] for s in steps)
    assert all(s["spans"][megakernel.SEGMENT_SPAN]["count"] >= 2
               for s in steps)
    assert all(w.eager and not w.b for w in megakernel._WAVES.values())
