"""Sharded progressive rendering over a process mesh (the JAX package's
``parallel/render.py``): image rows × samples.

Each rank keeps its stripe of ``H / n_tiles`` image rows of the
accumulator on its device across steps. The ranks of one tile render the
same rows at interleaved global sample ids and merge their partial sums
with one all-reduce over the samples group a step; ``gather_image``
all-gathers the stripes. Pixel and sample ids are global
(``megakernel.render_samples``'s ``row_start``, ``block_rows`` and
``sample_stride``), so any mesh gives the one-process image: bit for bit
with tiles only, up to the order of the samples axis's float sums
otherwise.

A rank's share of a step is ``rank_block``, a plain function of the mesh
coordinates and the state: the distributed step calls it, and a
one-process loop over every rank of a layout reproduces the step
without a process group.

The CLI takes this path under ``torchrun`` (``torchrun
--nproc_per_node=N -m pathtracing_tpu_torch.render``: one process per
card; ``--device cpu`` for gloo on the CPU) and writes the image from
rank 0.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pathtracing_tpu_torch.models import megakernel
from pathtracing_tpu_torch.models.progressive import RenderState
from pathtracing_tpu_torch.parallel.mesh import Mesh
from pathtracing_tpu_torch.utils.config import RenderConfig


def _check(n_tiles: int, n_samples: int, config: RenderConfig) -> None:
    if config.height % n_tiles:
        raise ValueError(
            f"height {config.height} not divisible by tiles axis {n_tiles}"
        )
    if config.samples_per_step % n_samples:
        raise ValueError(
            f"samples_per_step {config.samples_per_step} not divisible by "
            f"samples axis {n_samples}"
        )


def init_sharded_state(mesh: Mesh, config: RenderConfig) -> RenderState:
    """This rank's empty stripe, (H / n_tiles, W, 3), on the mesh's
    device."""
    _check(mesh.n_tiles, 1, config)
    return RenderState(
        accum=torch.zeros((config.height // mesh.n_tiles, config.width, 3),
                          dtype=torch.float32, device=mesh.device),
        spp=0, seed=int(config.seed))


def rank_block(scene, camera, config: RenderConfig, state: RenderState,
               n_tiles: int, n_samples: int, tile: int,
               sample: int) -> torch.Tensor:
    """The partial sum one rank at (``tile``, ``sample``) of an
    ``n_tiles`` × ``n_samples`` mesh adds in one step: its stripe's rows,
    every ``n_samples``-th sample id from ``state.spp + sample``."""
    block_rows = config.height // n_tiles
    return megakernel.render_samples(
        scene, camera, config, sample_start=state.spp + sample,
        n_samples=config.samples_per_step // n_samples, seed=state.seed,
        row_start=tile * block_rows, block_rows=block_rows,
        sample_stride=n_samples,
    )


def make_sharded_step(mesh: Mesh, config: RenderConfig):
    """The step of this rank: ``step(state, scene, camera) -> state`` adds
    ``samples_per_step`` samples to the stripe (in place). Every rank of
    the mesh must call it the same number of times (one all-reduce over
    the samples group a step). Needs H % n_tiles == 0 and
    samples_per_step % n_samples == 0."""
    _check(mesh.n_tiles, mesh.n_samples, config)

    def step(state: RenderState, scene, camera) -> RenderState:
        block = rank_block(scene, camera, config, state, mesh.n_tiles,
                           mesh.n_samples, mesh.tile, mesh.sample)
        dist.all_reduce(block, op=dist.ReduceOp.SUM,
                        group=mesh.samples_group)
        state.accum.add_(block)
        return RenderState(accum=state.accum,
                           spp=state.spp + config.samples_per_step,
                           seed=state.seed)

    return step


def gather_image(state: RenderState, mesh: Mesh) -> torch.Tensor:
    """The full mean-radiance image (H, W, 3) on every rank: one
    all-gather of the row stripes over the tiles group, then the mean."""
    stripes = [torch.empty_like(state.accum) for _ in range(mesh.n_tiles)]
    dist.all_gather(stripes, state.accum.contiguous(),
                    group=mesh.tiles_group)
    return torch.cat(stripes) / float(max(state.spp, 1))

