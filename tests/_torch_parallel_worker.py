"""One rank of a gloo process group on the CPU, for
tests/test_torch_parallel.py and tests/test_torch_parallel_adaptive.py.

    python tests/_torch_parallel_worker.py OUT_DIR CASE [CASE ...]

with torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK) set by the test. ``parallel.mesh.multihost_init`` joins the
group; each case runs on every rank, in order, and writes what the test
compares into OUT_DIR: each rank its stripe as ``<case>.r<rank>.npy``,
rank 0 the gathered image and any numbers. Prints WORKER_OK at the end.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from pathtracing_tpu_torch.models import scenes  # noqa: E402
from pathtracing_tpu_torch.ops.camera import build_camera  # noqa: E402
from pathtracing_tpu_torch.parallel import adaptive as padaptive  # noqa
from pathtracing_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from pathtracing_tpu_torch.parallel import render as prender  # noqa: E402
from pathtracing_tpu_torch.utils.config import (  # noqa: E402
    DeviceConfig, RenderConfig)

torch.set_num_threads(1)

# The configurations the test modules compare against.
CFG = RenderConfig(width=16, height=16, samples_per_pixel=4, max_depth=3,
                   seed=21, samples_per_step=4)
FEATURE_CFG = RenderConfig(width=16, height=16, samples_per_pixel=2,
                           max_depth=4, seed=5, samples_per_step=2,
                           background="gradient")
TILE = 2          # 8x8 = 64 tiles of 2x2 pixels
K = 16            # tiles a greedy round (k / n per rank)
GREEDY_ROUNDS = 3
BUDGET = 16       # spp of the budget and target_rmse renders

OUT = sys.argv[1]
RANK = DEVICE = None


def put(name, array, rank_file=True):
    """Save ``array`` as ``<name>.r<rank>.npy``, or once as
    ``<name>.npy`` from rank 0."""
    array = np.asarray(array.cpu() if torch.is_tensor(array) else array)
    if rank_file:
        np.save(os.path.join(OUT, f"{name}.r{RANK}.npy"), array)
    elif RANK == 0:
        np.save(os.path.join(OUT, f"{name}.npy"), array)


def put_json(name, value):
    if RANK == 0:
        with open(os.path.join(OUT, f"{name}.json"), "w") as f:
            json.dump(value, f)


def scene_of(name):
    scene, cam_cfg = scenes.get_scene(name, device="cpu")
    return scene, build_camera(cam_cfg, 1.0, device="cpu")


def sharded(case, n_tiles, n_samples, scene_name, cfg, steps):
    scene, cam = scene_of(scene_name)
    mesh = mesh_mod.make_mesh(n_tiles, n_samples, device=DEVICE)
    assert (mesh.tile, mesh.sample) == divmod(RANK, n_samples)
    step = prender.make_sharded_step(mesh, cfg)
    state = prender.init_sharded_state(mesh, cfg)
    for _ in range(steps):
        state = step(state, scene, cam)
    put(case, state.accum)
    put(case + ".image", prender.gather_image(state, mesh), rank_file=False)
    put_json(case, {"spp": state.spp, "mesh": [mesh.n_tiles,
                                               mesh.n_samples]})


def errors(case, calls):
    out = []
    for fn in calls:
        try:
            fn()
            out.append(None)
        except (ValueError, RuntimeError) as e:
            out.append(str(e))
    put_json(case, out)


def case_layouts():
    """Every (tiles, samples) layout of the world among (n, 1), (2, n/2)
    and (1, n)."""
    world = dist.get_world_size()
    for n_tiles in sorted({t for t in (world, 2, 1) if world % t == 0},
                          reverse=True):
        n_samples = world // n_tiles
        sharded(f"layout_{n_tiles}x{n_samples}", n_tiles, n_samples,
                "cornell_sphere", CFG, 1)


def case_two_steps():
    sharded("two_steps", 2, dist.get_world_size() // 2, "cornell_sphere",
            CFG, 2)


def case_feature():
    sharded("feature", dist.get_world_size(), 1, "spotlight_demo",
            FEATURE_CFG, 1)


def case_invalid():
    world = dist.get_world_size()
    errors("invalid", [
        lambda: prender.make_sharded_step(
            mesh_mod.make_mesh(world, 1, device=DEVICE),
            RenderConfig(width=16, height=10, samples_per_step=4)),
        lambda: prender.make_sharded_step(
            mesh_mod.make_mesh(2, world // 2, device=DEVICE),
            RenderConfig(width=16, height=16, samples_per_step=3)),
        lambda: mesh_mod.make_mesh(3, 1, device=DEVICE),
        lambda: mesh_mod.mesh_from_config(DeviceConfig(mesh_shape=(1, 3)),
                                           device=DEVICE),
        # A valid shape: no error.
        lambda: mesh_mod.mesh_from_config(DeviceConfig(mesh_shape=(world,)),
                                           device=DEVICE),
        # No device named: the card, which this CPU-only group lacks.
        lambda: mesh_mod.make_mesh(world, 1),
    ])


def case_uniform():
    scene, cam = scene_of("cornell_sphere")
    mesh = mesh_mod.make_mesh(device=DEVICE)
    state = padaptive.init_sharded_tile_state(mesh, CFG, TILE)
    state = padaptive.make_sharded_uniform_step(mesh, CFG, TILE)(
        state, scene, cam, 3)
    put("uniform.spp", state.tile_spp)
    put("uniform.image", padaptive.gather_tile_image(state, mesh, CFG, TILE),
        rank_file=False)


def case_greedy():
    scene, cam = scene_of("cornell_sphere")
    mesh = mesh_mod.make_mesh(device=DEVICE)
    state = padaptive.init_sharded_tile_state(mesh, CFG, TILE)
    state = padaptive.make_sharded_uniform_step(mesh, CFG, TILE)(
        state, scene, cam, 2)
    state = padaptive.make_sharded_tile_rounds(
        mesh, CFG, TILE, K, spp_per_round=1)(state, scene, cam,
                                             GREEDY_ROUNDS)
    put("greedy.accum", state.accum)
    put("greedy.m2", state.m2)
    put("greedy.spp", state.tile_spp)


def case_budget():
    scene, cam = scene_of("cornell_sphere")
    mesh = mesh_mod.make_mesh(device=DEVICE)
    state, rounds = padaptive.render_adaptive_sharded(
        mesh, scene, cam, CFG, tile=TILE, tiles_per_round=K, budget_spp=6)
    put("budget.spp", state.tile_spp)
    put("budget.image", padaptive.gather_tile_image(state, mesh, CFG, TILE),
        rank_file=False)
    put_json("budget", {"rounds": rounds})


def case_target():
    scene, cam = scene_of("cornell_sphere")
    mesh = mesh_mod.make_mesh(device=DEVICE)
    kw = dict(tile=TILE, tiles_per_round=K, budget_spp=BUDGET)
    base, _ = padaptive.render_adaptive_sharded(mesh, scene, cam, CFG, **kw)
    loose = padaptive.predicted_rmse(base, mesh, CFG, TILE) * 4.0
    state, _ = padaptive.render_adaptive_sharded(
        mesh, scene, cam, CFG, target_rmse=loose, **kw)
    reached = padaptive.predicted_rmse(state, mesh, CFG, TILE)
    full, _ = padaptive.render_adaptive_sharded(
        mesh, scene, cam, CFG, target_rmse=1e-9, **kw)
    put("target.base", base.accum)
    put("target.base_spp", base.tile_spp)
    put("target.spp", state.tile_spp)
    put("target.full", full.accum)
    put("target.full_spp", full.tile_spp)
    put_json("target", {"loose": loose, "reached": reached})


def case_adaptive_invalid():
    world = dist.get_world_size()
    errors("adaptive_invalid", [
        lambda: padaptive.init_sharded_tile_state(
            mesh_mod.make_mesh(1, world, device=DEVICE), CFG, TILE),
        lambda: padaptive.make_sharded_tile_rounds(
            mesh_mod.make_mesh(device=DEVICE), CFG, TILE, 3),
        lambda: padaptive.init_sharded_tile_state(
            mesh_mod.make_mesh(device=DEVICE), CFG, 3),
    ])


if __name__ == "__main__":
    DEVICE = mesh_mod.multihost_init("cpu")
    assert DEVICE == torch.device("cpu") and dist.get_backend() == "gloo"
    RANK = dist.get_rank()
    for name in sys.argv[2:]:
        globals()["case_" + name]()
    dist.barrier()
    dist.destroy_process_group()
    print("WORKER_OK", flush=True)
