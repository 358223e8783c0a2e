"""Port parity: the CLI ``python -m pathtracing_tpu_torch.render`` (the
JAX package's tests/test_cli.py), run in-process with ``--device cpu``
unless a case needs a fresh interpreter.

Exact, on the CPU: a render interrupted after one of two steps and
resumed from its checkpoint writes the uninterrupted render's radiance
(``--out-hdr``) bit for bit, and so does one whose SIGINT arrives inside
a step (it takes effect after the step, so the checkpoint holds whole
steps: ``render_step`` adds to the accumulator in place); a band-tiled render that loses a band
(``--tiles 4 --inject-fault 1``) writes the progressive render's radiance
bit for bit; snapshots are written one step late (the asynchronous
present) and the last one before the final image.

Refusals (exit 2, a message, no traceback): a resume under another
config, an unknown scene, ``--target-rmse`` without ``--adaptive`` in
every branch, ``--adaptive --target-rmse`` with ``--aov``, ``--orbit`` or
``--tiles`` (the JAX CLI ignores both flags there, ROADMAP caveat C6), no
CUDA device without ``--device cpu``, a non-finite accumulator under
``--debug``.

Against the JAX package: its ``main`` in-process with
``--traversal cluster_jax`` and the port's on cornell_sphere (16x16,
depth 3, 4 spp) write ``--out-hdr`` radiance within the render tolerance
of tests/test_torch_render.py (at most 1% of pixels over 1e-3, means
within 1%).
"""

import json
import logging
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from pathtracing_tpu import render as jrender
from pathtracing_tpu.models import progressive as jprog
from pathtracing_tpu.utils import metrics as jmetrics
from pathtracing_tpu.utils.config import RenderConfig as JConfig
from pathtracing_tpu_torch import render
from pathtracing_tpu_torch.models import progressive
from pathtracing_tpu_torch.ops.envmap import load_hdr
from pathtracing_tpu_torch.utils import config as tconfig
from pathtracing_tpu_torch.utils import image, metrics
from pathtracing_tpu_torch.utils import logging as ptlog

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--scene", "cornell_sphere", "--width", "16",
         "--height", "16", "--max-depth", "3"]


@pytest.fixture
def said():
    """Messages the port logs while a test runs."""
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Keep()
    ptlog.get_logger().addHandler(handler)
    yield lines
    ptlog.get_logger().removeHandler(handler)


def run_cli(*args, env=None):
    """The CLI in a fresh interpreter, the way a user runs it."""
    return subprocess.run(
        [sys.executable, "-m", "pathtracing_tpu_torch.render", *args],
        cwd=REPO, env={**os.environ, **(env or {})}, capture_output=True,
        text=True, timeout=240,
    )


def _radiance(path):
    with np.load(path) as data:
        return data["radiance"], int(data["spp"])


def test_render_and_resume(tmp_path, monkeypatch, said):
    ck, hdr = str(tmp_path / "ck.npz"), str(tmp_path / "r.npz")
    base = [*SMALL, "--spp", "4", "--spp-per-step", "2",
            "--out", str(tmp_path / "r.png"), "--out-hdr", hdr]
    assert render.main(base) == 0
    want, _ = _radiance(hdr)

    # Interrupted (Ctrl-C) during its second step: the state at 2 spp is
    # checkpointed on the way out.
    real, calls = progressive.render_step, []

    def interrupted(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return real(*a, **k)

    with monkeypatch.context() as mp:
        mp.setattr(progressive, "render_step", interrupted)
        assert render.main([*base, "--checkpoint", ck]) == 0
    assert any("interrupted at 2 spp" in s for s in said)
    assert _radiance(hdr)[1] == 2
    assert render.main([*base, "--checkpoint", ck]) == 0
    assert any("resumed from" in s and "at 2 spp" in s for s in said)
    got, spp = _radiance(hdr)
    assert spp == 4 and np.array_equal(got, want)

    # Resuming under another config refuses cleanly: exit 2, no traceback.
    r = run_cli(*base, "--checkpoint", ck, "--seed", "7")
    assert r.returncode == 2
    assert "refusing to resume" in r.stderr
    assert "Traceback" not in r.stderr


def test_ctrl_c_stops_between_steps(tmp_path, monkeypatch, said):
    """A SIGINT that arrives inside a step takes effect after it: the
    checkpoint holds whole steps, and resuming equals the uninterrupted
    render bit for bit."""
    ck, hdr = str(tmp_path / "ck.npz"), str(tmp_path / "r.npz")
    base = [*SMALL, "--spp", "6", "--spp-per-step", "2",
            "--out", str(tmp_path / "r.png"), "--out-hdr", hdr]
    assert render.main(base) == 0
    want, _ = _radiance(hdr)
    real = progressive.render_step

    def signalled(state, *a, **k):
        out = real(state, *a, **k)
        if out.spp == 4:
            os.kill(os.getpid(), signal.SIGINT)
        return out

    with monkeypatch.context() as mp:
        mp.setattr(progressive, "render_step", signalled)
        assert render.main([*base, "--checkpoint", ck]) == 0
    assert any("interrupted at 4 spp" in s for s in said)
    assert render.main([*base, "--checkpoint", ck]) == 0
    got, spp = _radiance(hdr)
    assert spp == 6 and np.array_equal(got, want)


def test_no_gpu_without_device_cpu_exits():
    r = run_cli("--scene", "cornell_sphere", "--width", "8", "--height",
                "8", "--spp", "1", env={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 2
    assert "no CUDA device" in r.stderr and "--device cpu" in r.stderr
    assert "Traceback" not in r.stderr


@pytest.mark.parametrize("extra", [[], ["--tiles", "2"],
                                   ["--aov", "normal"], ["--orbit", "2"]])
def test_target_rmse_requires_adaptive_in_every_branch(tmp_path, said,
                                                       extra):
    assert render.main([*SMALL, "--spp", "2", "--target-rmse", "0.5",
                        "--out", str(tmp_path / "x.png"), *extra]) == 2
    assert any("--target-rmse" in s for s in said)
    assert not os.path.exists(tmp_path / "x.png")


@pytest.mark.parametrize("extra", [["--aov", "normal"], ["--orbit", "2"],
                                   ["--tiles", "2"]])
def test_adaptive_target_rmse_rejected_where_ignored(tmp_path, said, extra):
    """Caveat C6: the JAX CLI renders these branches and silently ignores
    --adaptive --target-rmse; the port refuses."""
    assert render.main([*SMALL, "--spp", "2", "--adaptive",
                        "--target-rmse", "0.5",
                        "--out", str(tmp_path / "x.png"), *extra]) == 2
    assert any("cannot be combined" in s for s in said)
    assert not any(p.name.startswith("x") for p in tmp_path.iterdir())


def test_unknown_scene_exit_code(said):
    assert render.main(["--device", "cpu", "--scene", "nope", "--width",
                        "8", "--height", "8", "--spp", "1"]) == 2
    assert any("unknown scene" in s for s in said)


def test_traversal_takes_the_port_modes():
    parser = render.build_parser()
    for mode in ("auto", *tconfig.TRAVERSALS):
        assert parser.parse_args(["--traversal", mode]).traversal == mode
    with pytest.raises(SystemExit):
        parser.parse_args(["--traversal", "cluster_jax"])


def test_aov_flag(tmp_path):
    out = str(tmp_path / "n.png")
    assert render.main([*SMALL, "--aov", "normal", "--out", out]) == 0
    img = image.decode_png(open(out, "rb").read())
    assert img.shape == (16, 16, 3)


@pytest.mark.parametrize("extra", [[], ["--engine", "wavefront"]])
def test_json_scene_render(tmp_path, extra):
    out = str(tmp_path / "j.png")
    assert render.main([
        "--device", "cpu", "--scene", os.path.join(REPO, "examples",
                                                   "cornell.json"),
        "--width", "12", "--height", "12", "--spp", "2",
        "--spp-per-step", "2", "--max-depth", "2", "--out", out,
        *extra]) == 0
    assert os.path.getsize(out) > 100


def test_orbit_frames(tmp_path):
    out = str(tmp_path / "seq" / "f.png")
    assert render.main(["--device", "cpu", "--scene", "cornell_sphere",
                        "--width", "12", "--height", "12", "--spp", "2",
                        "--max-depth", "2", "--orbit", "3",
                        "--out", out]) == 0
    frames = [image.decode_png(open(str(tmp_path / "seq" / f"f_{i:04d}.png"),
                                    "rb").read()) for i in range(3)]
    assert all(f.shape == (12, 12, 3) for f in frames)
    # The camera moves, so consecutive frames differ.
    assert not np.array_equal(frames[0], frames[1])


def test_orbit_temporal_denoise(tmp_path, said):
    out = str(tmp_path / "t.png")
    assert render.main([*SMALL, "--spp", "1", "--orbit", "2",
                        "--orbit-degrees", "20", "--temporal", "--denoise",
                        "--out", out]) == 0
    assert (tmp_path / "t_0000.png").exists()
    assert (tmp_path / "t_0001.png").exists()
    assert sum(s.startswith("denoised") for s in said) == 2


def test_preview_flag_headless(tmp_path, said):
    """--preview with the Agg backend: the preview updates per step
    without a display."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    out = str(tmp_path / "p.png")
    assert render.main(["--device", "cpu", "--scene", "cornell_sphere",
                        "--width", "24", "--height", "24", "--spp", "4",
                        "--spp-per-step", "2", "--max-depth", "2",
                        "--preview", "--out", out]) == 0
    assert os.path.exists(out)
    assert not any("preview disabled" in s for s in said)


def test_preview_object_updates():
    import matplotlib

    matplotlib.use("Agg", force=True)
    p = render._Preview()
    assert p._plt is not None
    img = np.random.rand(8, 8, 3).astype(np.float32)
    p.update(img, 1)
    first = p._im
    assert first is not None
    p.update(torch.as_tensor(img) * 0.5, 2)
    assert p._im is first  # reuses the image artist
    assert p._ax.get_title() == "2 spp"


def test_resolve_preview_matches_jax():
    rs = np.random.RandomState(0)
    accum = (rs.rand(13, 22, 3) * 5).astype(np.float32)
    st = progressive.RenderState(accum=torch.as_tensor(accum), spp=5, seed=0)
    got = progressive.resolve_preview(st, 4)
    want = np.asarray(jprog.resolve_preview(jprog.RenderState(
        accum=accum, spp=np.int32(5), seed=np.uint32(0)), 4))
    assert got.shape == want.shape == (3, 5, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_snapshots_are_written_one_step_late(tmp_path, monkeypatch):
    """--snapshot-every 1: each step's snapshot is written while the next
    step runs, the last after the loop, then the final image."""
    written, spp_at_write = [], []
    real = image.write_image
    state_spp = []
    real_step = progressive.render_step

    def step(*a, **k):
        out = real_step(*a, **k)
        state_spp.append(out.spp)
        return out

    def write(path, img, *a, **k):
        written.append(float(torch.as_tensor(np.asarray(img)).mean()))
        spp_at_write.append(state_spp[-1])
        return real(path, img, *a, **k)

    monkeypatch.setattr(progressive, "render_step", step)
    monkeypatch.setattr(image, "write_image", write)
    assert render.main([*SMALL, "--spp", "3", "--spp-per-step", "1",
                        "--snapshot-every", "1",
                        "--out", str(tmp_path / "s.png")]) == 0
    # Snapshots of steps 1 and 2 during steps 2 and 3, step 3's after the
    # loop, the final image last.
    assert spp_at_write == [2, 3, 3, 3]
    assert written[2] == written[3]


def test_denoise_flag(tmp_path, said):
    out = str(tmp_path / "d.png")
    assert render.main(["--device", "cpu", "--scene", "cornell_sphere",
                        "--width", "32", "--height", "32", "--spp", "2",
                        "--spp-per-step", "2", "--max-depth", "3",
                        "--denoise", "--bloom", "0.1", "--out", out]) == 0
    assert os.path.exists(out)
    assert any(s.startswith("denoised") for s in said)
    assert any(s.startswith("bloom applied") for s in said)


def test_auto_background(tmp_path):
    """--background auto (the default) takes the gradient sky for the
    emitter-free demo scenes and a JSON scene's "background" key; an
    explicit value overrides it."""
    from PIL import Image

    out = str(tmp_path / "a.png")
    common = ["--device", "cpu", "--width", "24", "--height", "16", "--spp",
              "2", "--spp-per-step", "2", "--max-depth", "4", "--out", out]
    assert render.main(["--scene", "frosted_demo", *common]) == 0
    assert np.asarray(Image.open(out)).mean() > 20.0
    assert render.main(["--scene", "frosted_demo", "--background", "black",
                        *common]) == 0
    assert np.asarray(Image.open(out)).mean() < 2.0

    spec = {
        "background": "gradient",
        "camera": {"position": [0, 0, 3], "look_at": [0, 0, 0]},
        "materials": {"m": {"type": "lambertian", "albedo": [1, 1, 1]}},
        "objects": [{"type": "sphere", "center": [0, 0, 0],
                     "radius": 0.5, "material": "m"}],
    }
    p = tmp_path / "sky.json"
    p.write_text(json.dumps(spec))
    assert render.main(["--scene", str(p), *common]) == 0
    assert np.asarray(Image.open(out)).mean() > 20.0


def test_hdr_output(tmp_path):
    """--out .hdr writes linear Radiance RGBE that matches the npz
    radiance to RGBE quantization."""
    out, npz = str(tmp_path / "r.hdr"), str(tmp_path / "r.npz")
    assert render.main(["--device", "cpu", "--scene", "cornell_sphere",
                        "--width", "24", "--height", "16", "--spp", "4",
                        "--spp-per-step", "4", "--max-depth", "3",
                        "--out", out, "--out-hdr", npz]) == 0
    img = load_hdr(out)
    ref, spp = _radiance(npz)
    assert img.shape == ref.shape and spp == 4
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img, ref, rtol=0.01, atol=5e-3)


def test_cli_matches_jax(tmp_path):
    args = ["--scene", "cornell_sphere", "--width", "16", "--height", "16",
            "--spp", "4", "--spp-per-step", "2", "--max-depth", "3",
            "--seed", "3"]
    jhdr, thdr = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    assert jrender.main([*args, "--traversal", "cluster_jax",
                         "--out", str(tmp_path / "j.png"),
                         "--out-hdr", jhdr]) == 0
    assert render.main([*args, "--device", "cpu",
                        "--out", str(tmp_path / "t.png"),
                        "--out-hdr", thdr]) == 0
    (want, jspp), (got, tspp) = _radiance(jhdr), _radiance(thdr)
    assert jspp == tspp == 4 and got.shape == want.shape == (16, 16, 3)
    diff = np.abs(got - want).max(axis=-1)
    assert (diff > 1e-3).mean() <= 0.01
    assert abs(got.mean() - want.mean()) <= 0.01 * want.mean()
    assert got.mean() > 0.05


def test_tiles_with_fault_equal_progressive(tmp_path, said):
    hdr = str(tmp_path / "p.npz")
    common = [*SMALL, "--spp", "2", "--spp-per-step", "1",
              "--out", str(tmp_path / "x.png")]
    assert render.main([*common, "--out-hdr", hdr]) == 0
    want, _ = _radiance(hdr)
    ck = str(tmp_path / "tiles.npz")
    assert render.main([*common, "--tiles", "4", "--inject-fault", "1",
                        "--checkpoint", ck, "--out-hdr", hdr]) == 0
    got, spp = _radiance(hdr)
    assert spp == 2 and np.array_equal(got, want)
    assert sum(s == "band 1 at 1 spp" for s in said) == 2
    # A finished tiled checkpoint resumes and renders nothing more.
    said.clear()
    assert render.main([*common, "--tiles", "4", "--checkpoint", ck]) == 0
    assert any(s.startswith("resumed tiled render") for s in said)
    assert not any(s.startswith("band ") for s in said)


@pytest.mark.parametrize("extra", [
    [], ["--adaptive-granularity", "bands"], ["--target-rmse", "0.05"],
    ["--tiles", "4"]])
def test_adaptive_cli(tmp_path, said, extra):
    hdr = str(tmp_path / "a.npz")
    assert render.main([*SMALL, "--spp", "4", "--adaptive",
                        "--adaptive-tile", "4",
                        "--out", str(tmp_path / "a.png"),
                        "--out-hdr", hdr, *extra]) == 0
    assert os.path.exists(tmp_path / "a.png")
    if "--tiles" not in extra:
        img, spp = _radiance(hdr)
        assert np.isfinite(img).all() and img.mean() > 0.05 and spp >= 1
    assert any(s.startswith("wrote") for s in said)


def test_debug_route_and_finite_check(tmp_path, monkeypatch, said):
    cfg = tconfig.RenderConfig(debug=True)
    from pathtracing_tpu_torch.models import scenes

    scene, _ = scenes.cornell_sphere(device="cpu")
    assert cfg.resolve_traversal(scene) == "cluster_torch"
    out = str(tmp_path / "d.png")
    assert render.main([*SMALL, "--spp", "2", "--spp-per-step", "1",
                        "--debug", "--out", out]) == 0
    real = progressive.render_step

    def poisoned(state, *a, **k):
        out = real(state, *a, **k)
        if out.spp == 2:
            out.accum[3, 4, 1] = float("nan")
        return out

    monkeypatch.setattr(progressive, "render_step", poisoned)
    assert render.main([*SMALL, "--spp", "3", "--spp-per-step", "1",
                        "--debug", "--out", out]) == 2
    assert any("non-finite radiance after step 2" in s for s in said)


def test_profile_writes_a_trace(tmp_path):
    prof = str(tmp_path / "prof")
    assert render.main([*SMALL, "--spp", "1", "--spp-per-step", "1",
                        "--profile", prof,
                        "--out", str(tmp_path / "p.png")]) == 0
    with open(os.path.join(prof, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def test_metrics_match_jax(tmp_path):
    assert (metrics.rays_per_sample(24, 16, 5)
            == jmetrics.rays_per_sample(24, 16, 5))
    assert (metrics.rays_per_sample(24, 16, 5, 2.5)
            == jmetrics.rays_per_sample(24, 16, 5, 2.5))
    kw = dict(step=3, seconds=0.25, samples_added=2, total_spp=6,
              mrays_per_s=1.5, samples_per_s=3072.0)
    ours, theirs = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    metrics.MetricsLog(str(ours)).record(metrics.StepMetrics(**kw))
    jmetrics.MetricsLog(str(theirs)).record(jmetrics.StepMetrics(**kw))
    assert ours.read_text() == theirs.read_text()
    with metrics.Timer("cpu") as t:
        pass
    assert t.seconds >= 0.0


def test_render_config_from_json_matches_jax(tmp_path):
    from pathtracing_tpu.utils.config import (
        render_config_from_json as jfrom_json)

    p = tmp_path / "cfg.json"
    p.write_text(json.dumps({"width": 40, "height": 30, "seed": 7,
                             "nee": False, "clamp": 3.0}))
    ours = tconfig.render_config_from_json(str(p))
    assert ours == tconfig.RenderConfig(width=40, height=30, seed=7,
                                        nee=False, clamp=3.0)
    import dataclasses

    assert dataclasses.asdict(ours) == dataclasses.asdict(jfrom_json(str(p)))
    assert JConfig().samples_per_pixel == ours.samples_per_pixel
