"""Port parity: ``parallel/adaptive.py`` (the JAX package's
tests/test_parallel_adaptive.py) on a gloo process group of 2 on the CPU.

The group runs every case of this module once (a module fixture starts
tests/_torch_parallel_worker.py on 2 ranks under a time limit that kills
a hang); cornell_sphere 16x16, depth 3, seed 21, tiles of 2x2 (64, 32 a
rank), k = 16 (8 a rank). Exact, bit for bit:

  * the sharded uniform step (3 spp) against one progressive step of the
    same 3 samples;
  * per-shard greedy (2 spp of warmup, then 3 rounds of 1 spp) against a
    one-process simulation of the same policy: each stripe ranks its own
    tiles by ``adaptive.top_k`` and renders its top k/2;
  * ``render_adaptive_sharded`` with an unreachable ``target_rmse``
    against the same render without a target.

Budgets: a 6-spp render spends exactly 6 x 64 tile-samples; a
``target_rmse`` of 4 times the 16-spp render's predicted RMSE stops under
budget, with every tile at 2 spp or more and the all-reduced estimate at
or under the target. Bad shapes raise the JAX package's messages.

Against the JAX package: ``render_adaptive_sharded`` on 2 of the
conftest's virtual devices (``traversal="cluster_jax"``, the same config,
k and budget) gives the same tile spp map and round count as the gloo
group of 2, and an image within the render tolerance of
tests/test_torch_render.py (at most 1% of pixels over 1e-3, means within
1%).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from pathtracing_tpu_torch.models import adaptive, progressive, scenes
from pathtracing_tpu_torch.ops.camera import build_camera
from pathtracing_tpu_torch.utils.config import RenderConfig
from tests._torch_group import finish, start_group

torch.set_num_threads(2)

CFG = RenderConfig(width=16, height=16, samples_per_pixel=4, max_depth=3,
                   seed=21, samples_per_step=4)
TILE, K, ROUNDS, WORLD = 2, 16, 3, 2
K_LOCAL = K // WORLD
N_TILES = 64


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("world2")
    finish(start_group(WORLD, out, ["uniform", "greedy", "budget", "target",
                                    "adaptive_invalid"]))
    return out


def stripes(d, name):
    return np.concatenate([np.load(os.path.join(d, f"{name}.r{r}.npy"))
                           for r in range(WORLD)])


def meta(d, name):
    with open(os.path.join(d, name + ".json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def setup():
    scene, cam_cfg = scenes.cornell_sphere(device="cpu")
    return scene, build_camera(cam_cfg, 1.0, device="cpu")


def test_sharded_uniform_matches_progressive_bitwise(runs, setup):
    scene, cam = setup
    cfg = dataclasses.replace(CFG, samples_per_pixel=3, samples_per_step=3)
    ref = progressive.render_step(progressive.init_state(cfg, device="cpu"),
                                  scene, cam, cfg)
    img = np.load(os.path.join(runs, "uniform.image.npy"))
    np.testing.assert_array_equal(img, ref.accum.numpy() / 3.0)
    spp = stripes(runs, "uniform.spp")
    assert spp.min() == spp.max() == 3 and spp.size == N_TILES


def test_sharded_greedy_matches_single_process_simulation(runs, setup):
    scene, cam = setup
    t_local = N_TILES // WORLD
    sim = adaptive.init_tile_state(CFG, TILE, device="cpu")
    sim = adaptive.tile_step(sim, scene, cam, CFG, TILE,
                             torch.arange(N_TILES), 2)
    for _ in range(ROUNDS):
        scores = adaptive.tile_scores(sim, CFG, TILE)
        picks = [shard * t_local + adaptive.top_k(
                     scores[shard * t_local:(shard + 1) * t_local], K_LOCAL)
                 for shard in range(WORLD)]
        sim = adaptive.tile_step(sim, scene, cam, CFG, TILE,
                                 torch.cat(picks))
    np.testing.assert_array_equal(stripes(runs, "greedy.accum"),
                                  sim.accum.numpy())
    np.testing.assert_array_equal(stripes(runs, "greedy.m2"),
                                  sim.m2.numpy())
    np.testing.assert_array_equal(stripes(runs, "greedy.spp"),
                                  sim.tile_spp.numpy())
    # Each stripe spent exactly its share: 8 tiles a round.
    spp = stripes(runs, "greedy.spp").reshape(WORLD, -1)
    assert (spp.sum(axis=1) == 2 * t_local + ROUNDS * K_LOCAL).all()


def test_render_adaptive_sharded_budget_and_image(runs):
    spp = stripes(runs, "budget.spp")
    assert spp.sum() == 6 * N_TILES
    img = np.load(os.path.join(runs, "budget.image.npy"))
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all() and img.max() > 0.0
    # 2 warmup spp, then (6 - 2) * 64 / (16 * 2) greedy rounds.
    assert meta(runs, "budget")["rounds"] == 2 + 8


def test_render_adaptive_sharded_matches_jax(runs):
    import jax

    from pathtracing_tpu.models import scenes as jscenes
    from pathtracing_tpu.ops.camera import build_camera as jcamera
    from pathtracing_tpu.parallel import adaptive as jpadaptive
    from pathtracing_tpu.parallel import mesh as jmesh
    from pathtracing_tpu.utils.config import RenderConfig as JConfig

    if len(jax.devices()) < WORLD:
        pytest.skip(f"needs {WORLD} (virtual) JAX devices")
    jcfg = JConfig(traversal="cluster_jax", width=16, height=16,
                   samples_per_pixel=4, max_depth=3, seed=21,
                   samples_per_step=4)
    scene_j, cam_cfg = jscenes.cornell_sphere()
    mesh = jmesh.make_mesh(WORLD, 1, devices=jax.devices()[:WORLD])
    state, rounds = jpadaptive.render_adaptive_sharded(
        mesh, scene_j, jcamera(cam_cfg, 1.0), jcfg, tile=TILE,
        tiles_per_round=K, budget_spp=6)
    np.testing.assert_array_equal(stripes(runs, "budget.spp"),
                                  np.asarray(jax.device_get(state.tile_spp)))
    assert meta(runs, "budget")["rounds"] == rounds
    want = jpadaptive.gather_tile_image(state, jcfg, TILE)
    got = np.load(os.path.join(runs, "budget.image.npy"))
    assert (np.abs(got - want).max(axis=-1) > 1e-3).mean() <= 0.01
    assert abs(got.mean() - want.mean()) <= 0.01 * want.mean()


def test_render_adaptive_sharded_target_rmse(runs):
    out = meta(runs, "target")
    spp = stripes(runs, "target.spp")
    assert spp.sum() < 16 * spp.size
    assert spp.min() >= 2
    assert out["reached"] <= out["loose"]
    np.testing.assert_array_equal(stripes(runs, "target.full"),
                                  stripes(runs, "target.base"))
    np.testing.assert_array_equal(stripes(runs, "target.full_spp"),
                                  stripes(runs, "target.base_spp"))
    assert stripes(runs, "target.base_spp").sum() == 16 * N_TILES


def test_invalid_shapes_rejected(runs):
    out = meta(runs, "adaptive_invalid")
    assert out[0] == ("sharded adaptive uses the tiles mesh axis only; "
                      "build the mesh with n_samples=1")
    assert out[1] == ("tiles-per-round k=3 not divisible by tiles axis 2 "
                      "(each chip renders k/n per round)")
    assert out[2] == "image 16x16 not divisible by tile 3"


def test_tile_offset_keeps_global_sample_ids(setup):
    """A stripe's tile_step with its offset renders the global tiles'
    samples: the second half of a one-process state, bit for bit."""
    scene, cam = setup
    full = adaptive.tile_step(adaptive.init_tile_state(CFG, TILE,
                                                       device="cpu"),
                              scene, cam, CFG, TILE, torch.arange(N_TILES))
    half = adaptive.TileState(
        accum=torch.zeros(32, TILE, TILE, 3),
        m2=torch.zeros(32, TILE, TILE, 3),
        tile_spp=torch.zeros(32, dtype=torch.int32), seed=CFG.seed)
    half = adaptive.tile_step(half, scene, cam, CFG, TILE, torch.arange(32),
                              tile_offset=32)
    assert torch.equal(half.accum, full.accum[32:])
