"""Process mesh for sharded rendering (the JAX package's
``parallel/mesh.py``) on ``torch.distributed``.

The JAX package builds a 2D device ``Mesh`` with a ``tiles`` axis (each
device owns a stripe of image rows) and a ``samples`` axis (the same
pixels at interleaved sample ids, merged by a sum). Here each process of
the initialised process group holds one device, and the mesh is a small
record of where this rank sits and the two sets of process groups the
sharded steps reduce over. Ranks are laid out as the JAX
``reshape(n_tiles, n_samples)``: ``rank = tile * n_samples + sample``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from pathtracing_tpu_torch.utils.config import resolve_device

TILE_AXIS = "tiles"
SAMPLE_AXIS = "samples"

# torchrun's environment (``init_method="env://"`` reads the first four).
_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@dataclasses.dataclass(frozen=True)
class Mesh:
    n_tiles: int
    n_samples: int
    rank: int
    tile: int                 # this rank's stripe of image rows
    sample: int               # this rank's sample shard
    samples_group: object     # the ranks of this tile (sample-sum group)
    tiles_group: object       # the ranks of this sample shard (row stripes)
    device: torch.device


def _default_device() -> torch.device:
    """This rank's card, ``cuda:LOCAL_RANK``, whatever the backend; raises
    without one (``resolve_device``): the CPU only when asked for."""
    local = int(os.environ.get(
        "LOCAL_RANK", dist.get_rank() % max(torch.cuda.device_count(), 1)))
    return resolve_device(f"cuda:{local}")


def make_mesh(n_tiles: Optional[int] = None, n_samples: int = 1,
              device=None) -> Mesh:
    """The (tiles, samples) mesh over every rank of the initialised
    process group; ``n_tiles`` defaults to world size / ``n_samples``.
    Every rank must call it, with the same shape: it creates the process
    groups of both axes. ``device`` is where this rank renders: its card,
    ``cuda:LOCAL_RANK``, unless the caller asks for another (``"cpu"``
    with a gloo group)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group: run under "
            "torchrun with multihost_init(), or call "
            "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if n_tiles is None:
        n_tiles = world // n_samples
    if n_tiles * n_samples != world:
        raise ValueError(
            f"mesh {n_tiles}x{n_samples} != {world} devices"
        )
    device = _default_device() if device is None else torch.device(device)
    rank = dist.get_rank()
    tile, sample = divmod(rank, n_samples)
    samples_group = tiles_group = None
    # new_group is collective: every rank creates every group, in order.
    for t in range(n_tiles):
        group = dist.new_group([t * n_samples + s for s in range(n_samples)])
        if t == tile:
            samples_group = group
    for s in range(n_samples):
        group = dist.new_group([t * n_samples + s for t in range(n_tiles)])
        if s == sample:
            tiles_group = group
    return Mesh(n_tiles=n_tiles, n_samples=n_samples, rank=rank, tile=tile,
                sample=sample, samples_group=samples_group,
                tiles_group=tiles_group, device=device)


def mesh_from_config(cfg, device=None) -> Mesh:
    """The mesh a ``utils.config.DeviceConfig`` describes: ``mesh_shape``
    maps onto (tiles, samples); one entry puts every rank on the tiles
    axis."""
    shape = tuple(cfg.mesh_shape)
    n_samples = shape[1] if len(shape) > 1 else 1
    return make_mesh(shape[0], n_samples, device=device)


def multihost_init(device=None) -> Optional[torch.device]:
    """Join the process group that ``torchrun`` describes in its
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``) and return this rank's device; a no-op
    returning None when none of them is set.

    NCCL on ``cuda:LOCAL_RANK`` unless the caller asks for the CPU
    (``device="cpu"``), which takes gloo."""
    if not any(k in os.environ for k in _ENV):
        return None
    if device is not None and torch.device(device).type == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        device = resolve_device(
            f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
        torch.cuda.set_device(device)
        backend = "nccl"
    dist.init_process_group(backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    return device
