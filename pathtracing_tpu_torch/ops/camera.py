"""Pinhole / thin-lens camera (the JAX package's ``ops/camera.py``; the
ortho, fisheye and equirect projections and camera motion are not
ported yet).

``build_camera`` runs on the host in numpy, as the JAX package's does, and
uploads the frame to the device; ``generate_ray`` is a batched function
of film coordinates.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pathtracing_tpu_torch.ops import linalg, sampling
from pathtracing_tpu_torch.utils.config import CameraConfig, resolve_device


@dataclasses.dataclass(frozen=True)
class Camera:
    """World-space camera frame: (3,) float32 tensors plus the lens
    radius as a float32-exact Python scalar."""

    origin: torch.Tensor
    lower_left: torch.Tensor   # film corner at the focus distance
    horizontal: torch.Tensor   # full film width vector
    vertical: torch.Tensor     # full film height vector
    u: torch.Tensor            # right
    v: torch.Tensor            # up
    w: torch.Tensor            # backward (forward is -w)
    lens_radius: float         # 0 => pinhole


def build_camera(cfg: CameraConfig, aspect: float, device=None) -> Camera:
    """Host-side camera setup; runs once per scene/config. The camera's
    tensors live on ``device`` (the card unless the caller asks for
    another device)."""
    device = resolve_device(device)
    if cfg.projection != "pinhole":
        raise NotImplementedError(
            f"projection {cfg.projection!r} is not ported yet (ROADMAP "
            "queue A item 20)"
        )
    if cfg.motion_position is not None or cfg.motion_look_at is not None:
        raise NotImplementedError(
            "camera motion blur is not ported yet (ROADMAP queue A item 20)"
        )
    position = np.asarray(cfg.position, np.float32)
    look_at = np.asarray(cfg.look_at, np.float32)
    up = np.asarray(cfg.up, np.float32)

    theta = math.radians(cfg.vfov_degrees)
    half_h = math.tan(theta / 2.0)
    half_w = aspect * half_h

    w = position - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)

    focus = cfg.focus_distance
    lower_left = position - half_w * focus * u - half_h * focus * v - focus * w
    horizontal = 2.0 * half_w * focus * u
    vertical = 2.0 * half_h * focus * v

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Camera(
        origin=dev(position), lower_left=dev(lower_left),
        horizontal=dev(horizontal), vertical=dev(vertical),
        u=dev(u), v=dev(v), w=dev(w),
        lens_radius=float(np.float32(cfg.aperture / 2.0)),
    )


def generate_ray(camera: Camera, s, t, lens_u1, lens_u2):
    """Pinhole/thin-lens ray through film coords (s, t) in [0, 1]² (s left
    to right, t bottom to top); batched over the leading dims."""
    disk = sampling.uniform_in_disk(lens_u1, lens_u2) * camera.lens_radius
    offset = disk[..., 0:1] * camera.u + disk[..., 1:2] * camera.v
    origin = camera.origin + offset
    target = (
        camera.lower_left
        + s[..., None] * camera.horizontal
        + t[..., None] * camera.vertical
    )
    return origin, linalg.normalize(target - origin)
