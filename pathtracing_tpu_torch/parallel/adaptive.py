"""Sharded tile-granular adaptive sampling (the JAX package's
``parallel/adaptive.py``).

The tile-major state of ``models/adaptive.py`` (accum, m2, tile_spp) is
split over the mesh's tiles axis: each rank owns a contiguous stripe of
tiles and keeps it on its device across rounds.

Scheduling is per shard: each round every rank ranks ITS OWN tiles and
renders its local top-(k/n), by ``adaptive.top_k``'s stable descending
sort. Every rank spends the same rays each round whatever the noise
looks like, and a round needs no collective: scores, picks, renders and
index adds are all local. Sample ids are global (pixel, sample) counters
(``adaptive.tile_step`` with the stripe's ``tile_offset``), so any
schedule computes the same per-sample values; schedules differ only in
where the budget lands. A sharded schedule equals a one-process
simulation of the same per-shard policy bit for bit, and a uniform one
equals ``progressive`` at equal spp.

Only the ``target_rmse`` stop crosses ranks: the sums behind
``adaptive.predicted_rmse`` are all-reduced, and every rank takes the
stop decision from the reduced value, so all ranks make the same
collectives in the same order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from pathtracing_tpu_torch.models import adaptive
from pathtracing_tpu_torch.models.adaptive import TileState
from pathtracing_tpu_torch.parallel.mesh import Mesh
from pathtracing_tpu_torch.utils import logging as ptlog
from pathtracing_tpu_torch.utils import metrics
from pathtracing_tpu_torch.utils.config import RenderConfig


def _check(mesh: Mesh, config: RenderConfig, tile: int,
           k: int) -> Tuple[int, int, int]:
    n_dev = mesh.n_tiles
    if mesh.n_samples != 1:
        raise ValueError(
            "sharded adaptive uses the tiles mesh axis only; build the "
            "mesh with n_samples=1"
        )
    if config.height % tile or config.width % tile:
        raise ValueError(
            f"image {config.width}x{config.height} not divisible by "
            f"tile {tile}"
        )
    n_tiles = (config.height // tile) * (config.width // tile)
    if n_tiles % n_dev:
        raise ValueError(
            f"{n_tiles} tiles not divisible by tiles axis {n_dev}"
        )
    if k % n_dev:
        raise ValueError(
            f"tiles-per-round k={k} not divisible by tiles axis {n_dev} "
            "(each chip renders k/n per round)"
        )
    return n_dev, n_tiles, k // n_dev


def init_sharded_tile_state(mesh: Mesh, config: RenderConfig,
                            tile: int) -> TileState:
    """This rank's empty stripe of T / n tiles on the mesh's device."""
    n_dev, n_tiles, _ = _check(mesh, config, tile, mesh.n_tiles)
    t_local = n_tiles // n_dev
    return TileState(
        accum=torch.zeros((t_local, tile, tile, 3), dtype=torch.float32,
                          device=mesh.device),
        m2=torch.zeros((t_local, tile, tile, 3), dtype=torch.float32,
                       device=mesh.device),
        tile_spp=torch.zeros(t_local, dtype=torch.int32, device=mesh.device),
        seed=int(config.seed),
    )


def make_sharded_tile_rounds(mesh: Mesh, config: RenderConfig, tile: int,
                             k: int, spp_per_round: int = 1):
    """``rounds(state, scene, camera, n_rounds) -> state``: each round
    this rank re-scores its tiles, picks its top k/n and renders
    ``spp_per_round`` samples of each (in place, no collective)."""
    n_dev, n_tiles, k_local = _check(mesh, config, tile, k)
    offset = mesh.tile * (n_tiles // n_dev)

    def rounds(state: TileState, scene, camera,
               n_rounds: int) -> TileState:
        for _ in range(n_rounds):
            ids = adaptive.top_k(adaptive.tile_scores(state, config, tile),
                                 k_local)
            state = adaptive.tile_step(state, scene, camera, config, tile,
                                       ids, spp_per_round,
                                       tile_offset=offset)
        return state

    return rounds


def make_sharded_uniform_step(mesh: Mesh, config: RenderConfig, tile: int):
    """``step(state, scene, camera, n_samples) -> state``: every tile of
    this rank's stripe gets ``n_samples`` consecutive global sample ids
    (the sharded ``adaptive.uniform_tile_rounds``; equal to the uniform
    engines at equal spp)."""
    n_dev, n_tiles, _ = _check(mesh, config, tile, mesh.n_tiles)
    t_local = n_tiles // n_dev
    offset = mesh.tile * t_local

    def step(state: TileState, scene, camera, n_samples: int) -> TileState:
        ids = torch.arange(t_local, device=state.accum.device)
        return adaptive.tile_step(state, scene, camera, config, tile, ids,
                                  n_samples, tile_offset=offset)

    return step


def predicted_rmse(state: TileState, mesh: Mesh, config: RenderConfig,
                   tile: int) -> float:
    """``adaptive.predicted_rmse`` of the whole image from the ranks'
    stripes: one all-reduce of each rank's sum and count. Every rank of
    the mesh must call it together."""
    var1, n = adaptive._tile_var1(state)
    sums = torch.stack([(var1 / n[:, None, None, None]).sum().double(),
                        metrics.to_device("tiles.rmse", float(var1.numel()),
                                          torch.float64, var1.device)])
    dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=mesh.tiles_group)
    return metrics.host_read("tiles.rmse", float,
                             torch.sqrt(sums[0] / sums[1]))


def render_adaptive_sharded(mesh: Mesh, scene, camera,
                            config: RenderConfig, tile: int = 8,
                            tiles_per_round: int = 0,
                            warmup_spp: int = 2,
                            budget_spp: Optional[int] = None,
                            spp_per_round: int = 2,
                            target_rmse: float = 0.0,
                            ) -> Tuple[TileState, int]:
    """Sharded adaptive sampling to an average ``budget_spp`` (default
    ``config.samples_per_pixel``): a uniform warmup, then per-shard greedy
    rounds in dispatch groups (the sharded ``render_adaptive_tiles``).
    ``target_rmse`` > 0 stops once the all-reduced ``predicted_rmse``
    reaches it, checked after the warmup and after every group; the
    budget becomes a cap. Returns (this rank's state, rounds)."""
    n_dev = mesh.n_tiles
    n_tiles = (config.height // tile) * (config.width // tile)
    k = tiles_per_round or max(n_dev, (n_tiles // 8) // n_dev * n_dev)
    k = min(k, n_tiles)
    _check(mesh, config, tile, k)

    state = init_sharded_tile_state(mesh, config, tile)
    uniform = make_sharded_uniform_step(mesh, config, tile)
    greedy = make_sharded_tile_rounds(mesh, config, tile, k, spp_per_round)

    target = budget_spp if budget_spp is not None else (
        config.samples_per_pixel)
    budget = n_tiles * target
    spent = rounds = 0
    warm = min(warmup_spp, target)
    if target_rmse > 0.0 and warm < 2:
        # An n <= 1 variance estimate is zero and would stop at once.
        ptlog.log_warning(
            "target_rmse needs a warmup of >= 2 spp (got min(warmup_spp, "
            "budget) = %d) — stopping rule disabled, rendering the full "
            "budget", warm,
        )
        target_rmse = 0.0

    def hit_target(st: TileState) -> bool:
        return (target_rmse > 0.0
                and predicted_rmse(st, mesh, config, tile) <= target_rmse)

    if warm:
        state = uniform(state, scene, camera, warm)
        spent += warm * n_tiles
        rounds += warm
    if warm >= 2 and hit_target(state):
        return state, rounds

    spr = max(1, spp_per_round)
    samples_per_round = k * tile * tile * spr
    per_dispatch = max(1, adaptive.MAX_DISPATCH_SAMPLES // samples_per_round)
    if target_rmse > 0.0:
        # Check the stopping rule about every 2 average spp.
        per_dispatch = min(per_dispatch, max(1, (n_tiles * 2) // (k * spr)))
    while spent + k * spr <= budget:
        n_r = min(per_dispatch, (budget - spent) // (k * spr))
        state = greedy(state, scene, camera, n_r)
        spent += n_r * k * spr
        rounds += n_r
        if hit_target(state):
            break
    return state, rounds


def gather_tile_image(state: TileState, mesh: Mesh, config: RenderConfig,
                      tile: int) -> torch.Tensor:
    """The full mean-radiance image (H, W, 3) on every rank: the stripes'
    radiance sums and counters all-gathered over the tiles group, then
    ``adaptive.resolve_tiles``."""
    def gather(x):
        parts = [torch.empty_like(x) for _ in range(mesh.n_tiles)]
        dist.all_gather(parts, x.contiguous(), group=mesh.tiles_group)
        return torch.cat(parts)

    full = TileState(accum=gather(state.accum), m2=state.m2,
                     tile_spp=gather(state.tile_spp), seed=state.seed)
    return adaptive.resolve_tiles(full, config, tile)
