"""Port parity: ``parallel/mesh.py`` and ``parallel/render.py`` (the JAX
package's tests/test_parallel.py and tests/test_multihost.py) on gloo
process groups on the CPU.

One group of 4 processes and one of 1 run every case of this module
(tests/_torch_parallel_worker.py, started once by a module fixture, each
rank joining through ``multihost_init`` from torchrun's environment); the
cases compare what they wrote. A worker that hangs in a collective is
killed at the fixture's time limit and the cases fail.

Exact, on cornell_sphere 16x16, depth 3, seed 21, 4 spp a step: the
tiles-only layouts (4, 1) and (1, 1), a feature scene (spotlight_demo:
delta lights, gradient sky) at (4, 1), and every rank's stripe, equal the
one-process image bit for bit. Layouts with a samples axis, (2, 2) and
(1, 4), and two (2, 2) steps are within rtol 1e-6 / atol 1e-5 of it (the
JAX package's tolerance: the samples' partial sums add in another order).
The one-process loop over every rank's ``rank_block``, merged in rank
order, equals the one-process image bit for bit with tiles only. Bad
shapes raise the JAX package's messages.

Against the JAX package: the port's (2, 2) image is within the render
tolerance of tests/test_torch_render.py (at most 1% of pixels over 1e-3,
means within 1%) of the JAX sharded image on the conftest's virtual
8-device mesh (2 x 2 of its devices, ``traversal="cluster_jax"``).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pathtracing_tpu.models import scenes as jscenes
from pathtracing_tpu.ops.camera import build_camera as jcamera
from pathtracing_tpu.parallel import mesh as jmesh
from pathtracing_tpu.parallel import render as jprender
from pathtracing_tpu.utils.config import RenderConfig as JConfig
from pathtracing_tpu_torch.models import progressive, scenes
from pathtracing_tpu_torch.ops.camera import build_camera
from pathtracing_tpu_torch.parallel import mesh as mesh_mod
from pathtracing_tpu_torch.parallel import render as prender
from pathtracing_tpu_torch.utils import image
from pathtracing_tpu_torch.utils.config import DeviceConfig, RenderConfig
from tests._torch_group import TIME_LIMIT, finish, free_port, start_group

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = RenderConfig(width=16, height=16, samples_per_pixel=4, max_depth=3,
                   seed=21, samples_per_step=4)
FEATURE_CFG = RenderConfig(width=16, height=16, samples_per_pixel=2,
                           max_depth=4, seed=5, samples_per_step=2,
                           background="gradient")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run every case: a group of 4 and a group of 1, side by side."""
    four = tmp_path_factory.mktemp("world4")
    one = tmp_path_factory.mktemp("world1")
    procs4 = start_group(4, four, ["layouts", "two_steps", "feature",
                                   "invalid"])
    procs1 = start_group(1, one, ["layouts"])
    finish(procs4 + procs1)
    return {4: four, 1: one}


def load(d, name):
    return np.load(os.path.join(d, name + ".npy"))


def meta(d, name):
    with open(os.path.join(d, name + ".json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def setup():
    scene, cam_cfg = scenes.cornell_sphere(device="cpu")
    cam = build_camera(cam_cfg, 1.0, device="cpu")
    state = progressive.render_step(progressive.init_state(CFG, device="cpu"),
                                    scene, cam, CFG)
    return scene, cam, cam_cfg, state.accum.numpy()


def assemble(d, case, n_tiles, n_samples):
    """The image of the ranks' stripes, each tile from its sample-0 rank;
    every rank of a tile holds the same stripe."""
    stripes = []
    for t in range(n_tiles):
        ranks = [np.load(os.path.join(d, f"{case}.r{t * n_samples + s}.npy"))
                 for s in range(n_samples)]
        for r in ranks[1:]:
            assert np.array_equal(r, ranks[0])
        stripes.append(ranks[0])
    return np.concatenate(stripes)


@pytest.mark.parametrize("tiles,samples", [(4, 1), (2, 2), (1, 4), (1, 1)])
def test_mesh_matches_single_process(runs, setup, tiles, samples):
    _, _, _, ref = setup
    d = runs[tiles * samples]
    case = f"layout_{tiles}x{samples}"
    got = assemble(d, case, tiles, samples)
    assert meta(d, case) == {"spp": 4, "mesh": [tiles, samples]}
    image_ = load(d, case + ".image")
    np.testing.assert_array_equal(image_, got / 4.0)
    if samples == 1:
        # A disjoint spatial partition with per-pixel-identical arithmetic.
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)


def test_two_steps_match(runs, setup):
    scene, cam, _, _ = setup
    single = progressive.init_state(CFG, device="cpu")
    for _ in range(2):
        single = progressive.render_step(single, scene, cam, CFG)
    got = assemble(runs[4], "two_steps", 2, 2)
    np.testing.assert_allclose(got, single.accum.numpy(), rtol=1e-6,
                               atol=1e-5)
    img = load(runs[4], "two_steps.image")
    assert img.shape == (16, 16, 3) and meta(runs[4], "two_steps")["spp"] == 8


def test_feature_scene_matches_single_process(runs):
    scene, cam_cfg = scenes.spotlight_demo(device="cpu")
    cam = build_camera(cam_cfg, 1.0, device="cpu")
    ref = progressive.render_step(
        progressive.init_state(FEATURE_CFG, device="cpu"), scene, cam,
        FEATURE_CFG)
    np.testing.assert_array_equal(assemble(runs[4], "feature", 4, 1),
                                  ref.accum.numpy())


def test_invalid_mesh_shapes_rejected(runs):
    out = meta(runs[4], "invalid")
    assert out[0] == "height 10 not divisible by tiles axis 4"
    assert out[1] == "samples_per_step 3 not divisible by samples axis 2"
    assert out[2] == "mesh 3x1 != 4 devices"
    assert out[3] == "mesh 1x3 != 4 devices"
    assert out[4] is None
    # make_mesh without a device takes the card, never the CPU quietly.
    assert out[5] == "device cuda:0 requested but CUDA is absent"


@pytest.mark.parametrize("tiles,samples", [(4, 1), (2, 2), (1, 4)])
def test_layout_simulation(setup, tiles, samples):
    """Every rank's ``rank_block`` in one process, merged in rank order:
    what the distributed step computes, without a process group."""
    scene, cam, _, ref = setup
    state = progressive.init_state(CFG, device="cpu")
    stripes = []
    for t in range(tiles):
        block = None
        for s in range(samples):
            part = prender.rank_block(scene, cam, CFG, state, tiles, samples,
                                      t, s)
            block = part if block is None else block + part
        stripes.append(block)
    got = torch.cat(stripes).numpy()
    if samples == 1:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)


def test_matches_jax_sharded_image(runs, setup):
    _, _, cam_cfg, _ = setup
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) JAX devices")
    jcfg = JConfig(traversal="cluster_jax", width=16, height=16,
                   samples_per_pixel=4, max_depth=3, seed=21,
                   samples_per_step=4)
    scene_j, _ = jscenes.cornell_sphere()
    mesh = jmesh.make_mesh(2, 2, devices=jax.devices()[:4])
    state = jprender.init_sharded_state(mesh, jcfg)
    state = jprender.make_sharded_step(mesh, jcfg)(state, scene_j,
                                                   jcamera(cam_cfg, 1.0))
    want = np.asarray(jprender.gather_image(state))
    got = load(runs[4], "layout_2x2.image")
    diff = np.abs(got - want).max(axis=-1)
    assert (diff > 1e-3).mean() <= 0.01
    assert abs(got.mean() - want.mean()) <= 0.01 * want.mean()
    assert got.mean() > 0.05


def test_device_config_matches_jax():
    import dataclasses

    from pathtracing_tpu.utils.config import DeviceConfig as JDevice

    assert dataclasses.asdict(DeviceConfig()) == dataclasses.asdict(JDevice())
    assert DeviceConfig().mesh_shape == (1,)


def test_mesh_needs_a_process_group(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert mesh_mod.multihost_init("cpu") is None     # no torchrun: no-op
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_mesh()


def test_torchrun_entry_point(tmp_path, setup):
    """``torchrun -m pathtracing_tpu_torch.render`` with 2 ranks on the
    (2, 1) layout writes the one-process image's PNG."""
    _, _, _, ref = setup
    out = str(tmp_path / "par.png")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "pathtracing_tpu_torch.render",
         "--device", "cpu", "--scene", "cornell_sphere", "--width", "16",
         "--height", "16", "--spp", "4", "--spp-per-step", "4",
         "--max-depth", "3", "--seed", "21", "--samples", "1",
         "--out", out],
        cwd=REPO, env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                       "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        _, err = proc.communicate(timeout=TIME_LIMIT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        pytest.fail("torchrun hung")
    assert proc.returncode == 0, err[-3000:]
    got = image.decode_png(open(out, "rb").read())
    want = image.tonemap(torch.as_tensor(ref / 4.0)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("extra", [
    ["--tiles", "4"], ["--checkpoint", "ck.npz"], ["--samples", "2"]])
def test_sharded_cli_rejections(tmp_path, monkeypatch, extra):
    """Under torchrun (a gloo group of 1 in this process) the CLI refuses
    the branches a sharded render does not take, and a mesh that does
    not fit the world; without torchrun it refuses ``--samples``."""
    from pathtracing_tpu_torch import render

    argv = ["--device", "cpu", "--scene", "cornell_sphere", "--width", "16",
            "--height", "16", "--spp", "2", "--spp-per-step", "2",
            "--out", str(tmp_path / "x.png"), *extra]
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    if extra[0] == "--samples":
        assert render.main(argv) == 2          # not under torchrun
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert render.main(argv) == 2
    assert not torch.distributed.is_initialized()
    assert not os.path.exists(tmp_path / "x.png")
