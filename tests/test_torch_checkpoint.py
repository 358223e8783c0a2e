"""Port parity: ``utils/checkpoint.py`` (the JAX package's
tests/test_checkpoint.py, and the file shared by both packages).

Exact, on the CPU: an interrupted and resumed render equals the
uninterrupted one bit for bit; a config change is refused; the port's
``config_fingerprint`` equals the JAX package's for the same field values;
the file holds the JAX layout (``accum`` f32, ``spp`` i32, ``seed`` u32,
``fingerprint`` u8) and either package loads the other's file with the
accumulator bit for bit.

Across packages: a JAX-written checkpoint of cornell_sphere (12x12, depth
3, 2 of 4 steps of 2 spp) resumes in the port, and a port-written one in
the JAX package; the finished image agrees with the other package's
uninterrupted render within the render tolerance of
tests/test_torch_render.py (at most 1% of pixels over 1e-3, means within
1%). The checkpoint is written under ``traversal="auto"``, the default of
both CLIs; the JAX samples are traced on its ``cluster_jax`` route, as in
every parity test (its CPU "auto" route, "bvh", contracts multiply-adds,
ROADMAP caveat C8).

The CLI cases (reference image, a small render's metrics, resume of a
finished render) run the port's ``main`` in-process with ``--device cpu``.
"""

import dataclasses
import json
import logging

import numpy as np
import pytest
import torch

from pathtracing_tpu.models import progressive as jprog
from pathtracing_tpu.models import scenes as jscenes
from pathtracing_tpu.ops.camera import build_camera as jcamera
from pathtracing_tpu.utils import checkpoint as jckpt
from pathtracing_tpu.utils.config import RenderConfig as JConfig
from pathtracing_tpu_torch import render
from pathtracing_tpu_torch.models import progressive, scenes
from pathtracing_tpu_torch.ops.camera import build_camera
from pathtracing_tpu_torch.utils import checkpoint as ckpt
from pathtracing_tpu_torch.utils import image
from pathtracing_tpu_torch.utils import logging as ptlog
from pathtracing_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(2)

KW = dict(width=12, height=12, samples_per_pixel=8, max_depth=3, seed=9,
          samples_per_step=2)
CFG = RenderConfig(**KW)


@pytest.fixture(scope="module")
def setup():
    scene, cam_cfg = scenes.cornell_sphere(device="cpu")
    return scene, build_camera(cam_cfg, 1.0, device="cpu"), cam_cfg


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


def _steps(state, scene, cam, cfg, n):
    for _ in range(n):
        state = progressive.render_step(state, scene, cam, cfg)
    return state


def test_resume_bit_identical(tmp_path, setup):
    """Interrupt + resume == uninterrupted run, bit for bit."""
    scene, cam, _ = setup
    path = str(tmp_path / "render.ckpt.npz")
    full = _steps(progressive.init_state(CFG, device="cpu"), scene, cam,
                  CFG, 4)
    state = _steps(progressive.init_state(CFG, device="cpu"), scene, cam,
                   CFG, 2)
    ckpt.save(path, state, CFG)
    # The file is a copy: stepping on does not change it.
    state = _steps(state, scene, cam, CFG, 1)
    resumed = ckpt.load(path, CFG, device="cpu")
    assert resumed.spp == 4 and resumed.seed == 9
    resumed = _steps(resumed, scene, cam, CFG, 2)
    assert torch.equal(full.accum, resumed.accum)


def test_config_mismatch_refused(tmp_path):
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=4)
    path = str(tmp_path / "c.npz")
    ckpt.save(path, progressive.init_state(cfg, device="cpu"), cfg)
    other = RenderConfig(width=8, height=8, samples_per_pixel=4, seed=1)
    with pytest.raises(ValueError, match="different config"):
        ckpt.load(path, other, device="cpu")


def test_load_needs_a_device(tmp_path, monkeypatch):
    path = str(tmp_path / "c.npz")
    ckpt.save(path, progressive.init_state(CFG, device="cpu"), CFG)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ckpt.load(path, CFG)


@pytest.mark.parametrize("kw", [
    {}, KW, dict(KW, nee=False, clamp=2.5, background="gradient",
                 nee_candidates=4, debug=True, engine="wavefront")])
def test_fingerprint_matches_jax(kw):
    assert (ckpt.config_fingerprint(RenderConfig(**kw))
            == jckpt.config_fingerprint(JConfig(**kw)))


def test_file_layout_matches_jax(tmp_path, setup):
    scene, cam, _ = setup
    state = _steps(progressive.init_state(CFG, device="cpu"), scene, cam,
                   CFG, 1)
    ours, theirs = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    ckpt.save(ours, state, CFG)
    jckpt.save(theirs, jprog.RenderState(
        accum=state.accum.numpy(), spp=np.int32(state.spp),
        seed=np.uint32(state.seed)), JConfig(**KW))
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            assert np.array_equal(a[name], b[name]), name


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_package_resume(tmp_path, setup, writer):
    """One package renders 2 of 4 steps and checkpoints; the other loads
    the file (accumulator bit for bit) and finishes the render."""
    scene_t, cam_t, cam_cfg = setup
    scene_j, _ = jscenes.cornell_sphere()
    cam_j = jcamera(cam_cfg, 1.0)
    jcfg = JConfig(traversal="cluster_jax", **KW)
    jfile = dataclasses.replace(jcfg, traversal="auto")
    path = str(tmp_path / "x.npz")

    jstate = jprog.init_state(jcfg)
    for _ in range(2):
        jstate = jprog.render_step(jstate, scene_j, cam_j, jcfg)
    tstate = _steps(progressive.init_state(CFG, device="cpu"), scene_t,
                    cam_t, CFG, 2)
    if writer == "jax":
        jckpt.save(path, jstate, jfile)
        loaded = ckpt.load(path, CFG, device="cpu")
        assert np.array_equal(loaded.accum.numpy(), np.asarray(jstate.accum))
        assert loaded.spp == 4
        done = progressive.resolve(_steps(loaded, scene_t, cam_t, CFG, 2))
        for _ in range(2):
            jstate = jprog.render_step(jstate, scene_j, cam_j, jcfg)
        want = np.asarray(jprog.resolve(jstate))
    else:
        ckpt.save(path, tstate, CFG)
        loaded = jckpt.load(path, jfile)
        assert np.array_equal(np.asarray(loaded.accum), tstate.accum.numpy())
        assert int(loaded.spp) == 4
        for _ in range(2):
            loaded = jprog.render_step(loaded, scene_j, cam_j, jcfg)
        done = jprog.resolve(loaded)
        want = progressive.resolve(_steps(tstate, scene_t, cam_t, CFG, 2))
    done, want = np.asarray(done), np.asarray(want)
    diff = np.abs(done - want).max(axis=-1)
    assert (diff > 1e-3).mean() <= 0.01
    assert abs(done.mean() - want.mean()) <= 0.01 * want.mean()
    assert done.mean() > 0.05


def test_reference_scene(tmp_path):
    out = str(tmp_path / "ref.png")
    assert render.main(["--device", "cpu", "--scene", "reference",
                        "--width", "64", "--height", "48", "--out", out]) == 0
    img = image.decode_png(open(out, "rb").read())
    assert img.shape == (48, 64, 3)


def test_small_render_logs_metrics(tmp_path, said):
    out = str(tmp_path / "out.png")
    jsonl = str(tmp_path / "m.jsonl")
    assert render.main([
        "--device", "cpu", "--scene", "cornell_sphere", "--width", "16",
        "--height", "16", "--spp", "4", "--spp-per-step", "2",
        "--max-depth", "3", "--metrics-jsonl", jsonl, "--out", out]) == 0
    img = image.decode_png(open(out, "rb").read())
    assert img.shape == (16, 16, 3)
    assert sum("Mrays/s" in s for s in said) == 2
    with open(jsonl) as f:
        assert [json.loads(line)["total_spp"] for line in f] == [2, 4]


def test_checkpoint_cli(tmp_path, said):
    c = str(tmp_path / "ck.npz")
    args = ["--device", "cpu", "--scene", "cornell_sphere", "--width", "8",
            "--height", "8", "--spp", "4", "--spp-per-step", "2",
            "--max-depth", "2", "--checkpoint", c,
            "--out", str(tmp_path / "out.png")]
    assert render.main(args) == 0
    assert ckpt.load(c, ckpt_config(args), device="cpu").spp == 4
    # Resume (already complete: exits at once, still OK).
    said.clear()
    assert render.main(args) == 0
    assert any(s.startswith("resumed") for s in said)
    assert not any("Mrays/s" in s for s in said)


def ckpt_config(args):
    """The RenderConfig the CLI builds for ``args`` (cornell_sphere)."""
    a = render.build_parser().parse_args(args)
    return RenderConfig(width=a.width, height=a.height,
                        samples_per_pixel=a.spp, max_depth=a.max_depth,
                        seed=a.seed, samples_per_step=a.spp_per_step)
