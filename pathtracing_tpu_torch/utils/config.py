"""Configuration for the port: the JAX package's ``RenderConfig`` and
``CameraConfig`` with the same fields and defaults, plus the device rule.

``resolve_traversal`` picks the hand-written CUDA cluster kernels for a
scene on the card and their plain torch versions for a scene on the CPU
or in debug mode; ``"bvh"`` (the threaded-BVH walk in plain torch, the JAX
package's CPU default) is taken only when asked for. The JAX package's
``cluster_interpret`` mode has no counterpart here: debug mode's checked
route is the plain torch one. ``DeviceConfig`` describes the process
mesh of ``parallel/``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import torch

TRAVERSALS = ("cluster_cuda", "cluster_torch", "bvh")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another device. Raises when no GPU is present and the caller did
    not ask for the CPU — the port never falls back to the CPU quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain torch path on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is absent")
    return device


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Camera settings (the JAX package's ``utils.config.CameraConfig``):
    pose, field of view, thin-lens defocus, the projection ("pinhole",
    "ortho", "fisheye" or "equirect", ``ops.camera.PROJECTIONS``) and an
    optional pose at shutter close (camera motion blur)."""

    position: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    look_at: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    vfov_degrees: float = 90.0
    aperture: float = 0.0
    focus_distance: float = 1.0
    projection: str = "pinhole"
    motion_position: "Tuple[float, float, float] | None" = None
    motion_look_at: "Tuple[float, float, float] | None" = None

    def motion_pair(self) -> "Tuple[CameraConfig, CameraConfig] | None":
        """The (open, close) config pair, or None for a static camera."""
        if self.motion_position is None and self.motion_look_at is None:
            return None
        close = dataclasses.replace(
            self,
            position=(self.motion_position if self.motion_position
                      is not None else self.position),
            look_at=(self.motion_look_at if self.motion_look_at
                     is not None else self.look_at),
            motion_position=None, motion_look_at=None,
        )
        opened = dataclasses.replace(
            self, motion_position=None, motion_look_at=None
        )
        return opened, close


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Per-render settings; same fields and defaults as the JAX package's
    ``RenderConfig`` so one config can drive both packages."""

    width: int = 512
    height: int = 512
    samples_per_pixel: int = 64
    max_depth: int = 8
    rr_start_depth: int = 8
    seed: int = 0
    samples_per_step: int = 4
    engine: str = "megakernel"
    background: str = "black"
    wavefront_pool: int = 0
    traversal: str = "auto"        # "auto" | "cluster_cuda" |
    #                                "cluster_torch" | "bvh"
    nee: bool = True
    nee_candidates: int = 1
    sampler: str = "ld"
    clamp: float = 0.0
    ray_sort: bool = True
    dtype: str = "float32"
    debug: bool = False

    @property
    def resolution(self) -> Tuple[int, int]:
        return (self.height, self.width)

    def resolve_traversal(self, scene=None) -> str:
        """"auto" picks the CUDA kernels for a scene on the card and the
        plain torch versions for a scene on the CPU or with ``debug`` (the
        counterpart of the JAX package's checked, interpreted kernels)."""
        if self.traversal != "auto":
            if self.traversal not in TRAVERSALS:
                raise ValueError(
                    f"traversal {self.traversal!r} is not ported; expected "
                    f"one of {TRAVERSALS}"
                )
            return self.traversal
        if (not self.debug and scene is not None
                and scene.tri_v0.device.type == "cuda"):
            return "cluster_cuda"
        return "cluster_torch"


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """Process-mesh layout for sharded rendering (the JAX package's
    ``DeviceConfig``): ``mesh_shape`` maps onto (tiles, samples); the
    tiles axis shards image rows, the samples axis samples per pixel
    (merged by an all-reduce)."""

    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("tiles",)
    donate_state: bool = True


def render_config_from_json(path: str) -> RenderConfig:
    """A ``RenderConfig`` from a JSON object of its fields."""
    with open(path) as f:
        raw = json.load(f)
    return RenderConfig(**raw)
