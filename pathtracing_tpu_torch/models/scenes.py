"""Built-in Cornell scenes (the JAX package's ``models/scenes.py``):
cornell_sphere, cornell_bsdf and cornell_mesh with the same geometry,
materials and camera.

Cornell geometry: axis-aligned box spanning [-1, 1]³, open toward +z,
camera on the +z axis, an emissive quad centered on the ceiling.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from pathtracing_tpu_torch.models.scene import Scene, SceneBuilder
from pathtracing_tpu_torch.utils.config import CameraConfig

CORNELL_CAMERA = CameraConfig(
    position=(0.0, 0.0, 3.4),
    look_at=(0.0, 0.0, 0.0),
    up=(0.0, 1.0, 0.0),
    vfov_degrees=40.0,
)

LIGHT_RADIANCE = (15.0, 15.0, 15.0)


def _cornell_walls(b: SceneBuilder) -> None:
    white = b.lambertian((0.73, 0.73, 0.73))
    red = b.lambertian((0.65, 0.05, 0.05))
    green = b.lambertian((0.12, 0.45, 0.15))
    light = b.emissive(LIGHT_RADIANCE)
    b.add_quad((-1, -1, -1), (2, 0, 0), (0, 0, 2), white)    # floor
    b.add_quad((-1, 1, -1), (0, 0, 2), (2, 0, 0), white)     # ceiling
    b.add_quad((-1, -1, -1), (0, 2, 0), (2, 0, 0), white)    # back wall
    b.add_quad((-1, -1, -1), (0, 0, 2), (0, 2, 0), red)      # left wall
    b.add_quad((1, -1, -1), (0, 2, 0), (0, 0, 2), green)     # right wall
    # Ceiling light: 0.9×0.9 quad just below the ceiling.
    b.add_quad((-0.45, 0.995, -0.45), (0.9, 0, 0), (0, 0, 0.9), light)


def cornell_sphere(device=None) -> Tuple[Scene, CameraConfig]:
    """Lambertian-only Cornell box with one sphere."""
    b = SceneBuilder()
    _cornell_walls(b)
    ball = b.lambertian((0.73, 0.73, 0.73))
    b.add_sphere((0.0, -0.5, 0.0), 0.5, ball)
    return b.build(device), CORNELL_CAMERA


def cornell_bsdf(device=None) -> Tuple[Scene, CameraConfig]:
    """Diffuse + metal + dielectric spheres + emissive light."""
    b = SceneBuilder()
    _cornell_walls(b)
    diffuse = b.lambertian((0.4, 0.2, 0.8))
    mirror = b.metal((0.9, 0.8, 0.7), fuzz=0.05)
    glass = b.dielectric(ior=1.5)
    b.add_sphere((-0.55, -0.65, -0.2), 0.35, diffuse)
    b.add_sphere((0.55, -0.6, -0.35), 0.4, mirror)
    b.add_sphere((0.0, -0.62, 0.45), 0.38, glass)
    return b.build(device), CORNELL_CAMERA


def icosphere(subdivisions: int = 4, radius: float = 1.0):
    """Procedural icosphere mesh: (vertices (V,3) f64, faces (F,3) i64),
    20 * 4**subdivisions triangles."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            (-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
            (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
            (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1),
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
            (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
            (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
            (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
        ],
        np.int64,
    )
    for _ in range(subdivisions):
        edge_mid: Dict[Tuple[int, int], int] = {}
        new_verts = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts[a] + verts[b]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(new_verts)
                new_verts.append(m)
            return edge_mid[key]

        new_faces = []
        for a, b_, c in faces:
            ab, bc, ca = midpoint(a, b_), midpoint(b_, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b_, bc, ab), (c, ca, bc),
                          (ab, bc, ca)]
        verts = np.array(new_verts)
        faces = np.array(new_faces, np.int64)
    return verts * radius, faces


def cornell_mesh(subdivisions: int = 5,
                 device=None) -> Tuple[Scene, CameraConfig]:
    """High-poly icosphere in the Cornell box: ``subdivisions=6`` gives the
    flagship's 81,920 mesh triangles (938 clusters)."""
    b = SceneBuilder()
    _cornell_walls(b)
    body = b.lambertian((0.6, 0.55, 0.45))
    verts, faces = icosphere(subdivisions, radius=0.5)
    verts = verts + np.array([0.0, -0.5, 0.0])
    b.add_mesh(verts, faces, body)
    return b.build(device), CORNELL_CAMERA
