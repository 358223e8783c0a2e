"""Camera models (the JAX package's ``ops/camera.py``): pinhole with
thin-lens defocus, ortho, fisheye and equirect panorama, the shutter
interpolation of a moving camera, and the reference kernel's ray
generation.

``build_camera`` runs on the host in numpy, as the JAX package's does, and
uploads the frame to the device; ``generate_ray`` is a batched function
of film coordinates. A moving camera is an ``(open, close)`` pair of
cameras; ``lerp`` blends them at a per-ray shutter time. ``project``
inverts ``generate_ray`` for the lens-centre ray and ``cam_depth`` gives
a point's depth for the temporal reprojection.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pathtracing_tpu_torch.ops import linalg, sampling
from pathtracing_tpu_torch.utils.config import CameraConfig, resolve_device

PROJECTIONS = ("pinhole", "ortho", "fisheye", "equirect")

_PI = float(np.float32(np.pi))
_TWO_PI = float(np.float32(2.0 * np.pi))


@dataclasses.dataclass(frozen=True)
class Camera:
    """World-space camera frame: (3,) float32 tensors (or (R, 3) after a
    per-ray ``lerp``), and the scalars as float32-exact Python floats (or
    (R,) tensors after a ``lerp`` between endpoints that differ in them).
    ``half_fov``/``aspect`` drive the non-pinhole projections."""

    origin: torch.Tensor
    lower_left: torch.Tensor   # film corner at the focus distance
    horizontal: torch.Tensor   # full film width vector
    vertical: torch.Tensor     # full film height vector
    u: torch.Tensor            # right
    v: torch.Tensor            # up
    w: torch.Tensor            # backward (forward is -w)
    lens_radius: float         # 0 => pinhole
    half_fov: float = 0.0      # radians (the fisheye's angular radius)
    aspect: float = 1.0        # width / height
    projection: str = "pinhole"


def build_camera(cfg: CameraConfig, aspect: float, device=None) -> Camera:
    """Host-side camera setup; runs once per scene/config. The camera's
    tensors live on ``device`` (the card unless the caller asks for
    another device). A moving camera builds each pose of
    ``cfg.motion_pair()`` and passes the pair."""
    device = resolve_device(device)
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
    if cfg.projection not in PROJECTIONS:
        raise ValueError(
            f"unknown camera projection {cfg.projection!r}; expected one of "
            f"{PROJECTIONS}"
        )

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Camera(
        origin=dev(position), lower_left=dev(lower_left),
        horizontal=dev(horizontal), vertical=dev(vertical),
        u=dev(u), v=dev(v), w=dev(w),
        lens_radius=float(np.float32(cfg.aperture / 2.0)),
        half_fov=float(np.float32(theta / 2.0)),
        aspect=float(np.float32(aspect)),
        projection=cfg.projection,
    )


def lerp(cam0: Camera, cam1: Camera, time) -> Camera:
    """The pose at shutter ``time`` ((R,) f32 tensor, or a scalar) of two
    cameras from ``build_camera``: every field ``a + (b - a)·time`` in
    float32, then the unit axes renormalized. A per-ray time gives (R, 3)
    vectors; a scalar field the endpoints share stays that scalar
    (``a + 0·time`` is ``a``)."""
    if cam0.projection != cam1.projection:
        raise ValueError(
            f"motion endpoints disagree on projection: "
            f"{cam0.projection!r} vs {cam1.projection!r}"
        )
    if not isinstance(time, torch.Tensor):
        time = torch.tensor(float(np.float32(time)), dtype=torch.float32,
                            device=cam0.origin.device)
    tv = time[..., None]

    def mix(a, b):
        if isinstance(a, torch.Tensor):        # the (3,) frame vectors
            return a + (b - a) * tv
        if a == b:
            return a
        a32 = torch.tensor(a, dtype=torch.float32, device=time.device)
        return a32 + (torch.tensor(b, dtype=torch.float32,
                                   device=time.device) - a32) * time

    fields = {f.name: mix(getattr(cam0, f.name), getattr(cam1, f.name))
              for f in dataclasses.fields(Camera) if f.name != "projection"}
    for axis in ("u", "v", "w"):
        fields[axis] = linalg.normalize(fields[axis])
    return Camera(projection=cam0.projection, **fields)


def resolve(camera, time=0.5) -> Camera:
    """A motion pair ``(open, close)`` collapsed to its pose at ``time``;
    a single camera passes through."""
    if isinstance(camera, tuple):
        return lerp(camera[0], camera[1], time)
    return camera


def _per_ray(x):
    """A camera scalar ready to scale (..., 3) vectors: a (R,) tensor gets
    a trailing axis, a Python float stays."""
    return x[..., None] if isinstance(x, torch.Tensor) else x


def generate_ray(camera: Camera, s, t, lens_u1, lens_u2):
    """Ray through film coords (s, t) in [0, 1]² (s left to right, t
    bottom to top) for the camera's projection; batched over the leading
    dims.

    * ``pinhole``: perspective with thin-lens defocus (``lens_radius``).
    * ``ortho``: parallel rays along -w over the pinhole frustum's
      cross-section at the focus distance (the lens is ignored).
    * ``fisheye``: equidistant; the angle from the view axis grows with
      the NDC radius and reaches ``half_fov`` at the top and bottom edges.
    * ``equirect``: the full 360°×180° panorama, azimuth about ``v`` from
      the look direction across the columns, polar angle from ``v`` down
      the rows."""
    proj = camera.projection
    if proj == "pinhole":
        disk = (sampling.uniform_in_disk(lens_u1, lens_u2)
                * _per_ray(camera.lens_radius))
        offset = disk[..., 0:1] * camera.u + disk[..., 1:2] * camera.v
        origin = camera.origin + offset
        target = (
            camera.lower_left
            + s[..., None] * camera.horizontal
            + t[..., None] * camera.vertical
        )
        return origin, linalg.normalize(target - origin)
    if proj == "ortho":
        offset = ((s - 0.5)[..., None] * camera.horizontal
                  + (t - 0.5)[..., None] * camera.vertical)
        origin = camera.origin + offset
        return origin, (-camera.w).expand(origin.shape)
    if proj == "fisheye":
        x = (2.0 * s - 1.0) * camera.aspect
        y = 2.0 * t - 1.0
        r = torch.sqrt(x * x + y * y)
        theta = torch.clamp(r * camera.half_fov, max=_PI)
        # atan2(0, 0) = 0: the exact center ray is the view axis.
        phi = torch.atan2(y, torch.where(r > 0.0, x, 1.0))
        sin_t = torch.sin(theta)
        direction = ((sin_t * torch.cos(phi))[..., None] * camera.u
                     + (sin_t * torch.sin(phi))[..., None] * camera.v
                     - torch.cos(theta)[..., None] * camera.w)
        origin = camera.origin.expand(direction.shape)
        return origin, linalg.normalize(direction)
    if proj == "equirect":
        theta = (1.0 - t) * _PI              # polar angle from up (v)
        lam = (s - 0.5) * _TWO_PI            # azimuth from -w
        sin_t = torch.sin(theta)
        direction = ((sin_t * torch.sin(lam))[..., None] * camera.u
                     + torch.cos(theta)[..., None] * camera.v
                     - (sin_t * torch.cos(lam))[..., None] * camera.w)
        origin = camera.origin.expand(direction.shape)
        return origin, linalg.normalize(direction)
    raise ValueError(f"unknown camera projection {proj!r}")


def cam_depth(camera: Camera, p):
    """Scalar occlusion-compare depth of world points ``p`` (..., 3): the
    z-depth along the view axis for the planar projections (pinhole,
    ortho), the radial distance for the angular ones (fisheye,
    equirect)."""
    rel = p - camera.origin
    if camera.projection in ("pinhole", "ortho"):
        return linalg.dot(rel, -camera.w)
    return torch.sqrt(torch.clamp((rel * rel).sum(-1), min=1e-20))


def project(camera: Camera, p):
    """Inverse of ``generate_ray`` for the lens-centre ray: world points
    ``p`` (..., 3) -> film coordinates (s, t) and a validity mask (in
    front of the camera, or inside the angular range). The lens is
    ignored: reprojection wants the sharp pinhole mapping. Where the
    previous frame saw a world point (``models.temporal``)."""
    rel = p - camera.origin
    x = linalg.dot(rel, camera.u)
    y = linalg.dot(rel, camera.v)
    z = linalg.dot(rel, -camera.w)
    proj = camera.projection
    if proj in ("pinhole", "ortho"):
        hw = torch.sqrt((camera.horizontal ** 2).sum())
        hv = torch.sqrt((camera.vertical ** 2).sum())
        if proj == "ortho":
            return 0.5 + x / hw, 0.5 + y / hv, z > 1e-6
        focus = linalg.dot(camera.origin - camera.lower_left, camera.w)
        valid = z > 1e-6
        zs = torch.where(valid, z, 1.0)
        return (0.5 + focus * x / (zs * hw), 0.5 + focus * y / (zs * hv),
                valid)
    rn = torch.sqrt(torch.clamp((rel * rel).sum(-1), min=1e-20))
    if proj == "fisheye":
        theta = torch.acos(torch.clamp(z / rn, -1.0, 1.0))
        r_ndc = theta / camera.half_fov
        phi = torch.atan2(y, torch.where(x.abs() + y.abs() > 0.0, x, 1.0))
        s = 0.5 * (r_ndc * torch.cos(phi) / camera.aspect + 1.0)
        t = 0.5 * (r_ndc * torch.sin(phi) + 1.0)
        # On-film is the caller's (s, t) in [0, 1] test; only the exact
        # backward pole (phi undefined, r saturated) is invalid here.
        return s, t, theta < float(np.float32(np.pi * 0.999))
    if proj == "equirect":
        theta = torch.acos(torch.clamp(y / rn, -1.0, 1.0))
        # Azimuth about v measured from -w, over the full circle.
        lam = torch.atan2(x, z)
        return lam / _TWO_PI + 0.5, 1.0 - theta / _PI, rn > 1e-6
    raise ValueError(f"unknown camera projection {proj!r}")


def reference_ray(pixel_x, pixel_y, resolution_x, resolution_y):
    """The reference kernel's ray generation (``Test.hlsl:6-10``): uv =
    (pixel / resolution)·2 − 1 with y down, eye at (0, 0, 1), direction
    normalize((uv, −1)). Returns (origin, direction, uv)."""
    uv_x = (pixel_x / resolution_x) * 2.0 - 1.0
    uv_y = (pixel_y / resolution_y) * 2.0 - 1.0
    direction = linalg.normalize(
        torch.stack([uv_x, uv_y, -torch.ones_like(uv_x)], dim=-1))
    origin = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32,
                          device=direction.device).expand(direction.shape)
    return origin, direction, torch.stack([uv_x, uv_y], dim=-1)
