"""Built-in scenes (the JAX package's ``models/scenes.py``): the Cornell
family (cornell_sphere, cornell_bsdf, cornell_mesh), the instancing
showcase (instanced_demo) and the many-light hall (many_lights_demo), with
the same geometry, materials and cameras.

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


def cornell_mesh_builder(subdivisions: int) -> SceneBuilder:
    """The unbuilt cornell_mesh scene (to build with a forced page size)."""
    b = SceneBuilder()
    _cornell_walls(b)
    body = b.lambertian((0.6, 0.55, 0.45))
    verts, faces = icosphere(subdivisions, radius=0.5)
    verts = verts + np.array([0.0, -0.5, 0.0])
    b.add_mesh(verts, faces, body)
    return b


def cornell_mesh(subdivisions: int = 5,
                 device=None) -> Tuple[Scene, CameraConfig]:
    """High-poly icosphere in the Cornell box: ``subdivisions=6`` gives the
    flagship's 81,920 mesh triangles (938 clusters); 8 gives 1,310,720
    (14,736 clusters, past the flat kernels' budget: 8 pages of 2,048)."""
    return cornell_mesh_builder(subdivisions).build(device), CORNELL_CAMERA


def instanced_demo(grid: int = 12, subdivisions: int = 3,
                   device=None) -> Tuple[Scene, CameraConfig]:
    """Instancing showcase: a ``grid``×``grid`` field of one icosphere
    prototype (stored ONCE, ``SceneBuilder.add_instances``), each copy
    rotated, squashed and placed on a ground plane under the gradient sky
    plus a sun-like area light. At the defaults 144 instances of a
    1,280-triangle prototype (16 SAH clusters) trace as ~184k effective
    triangles over 2,305 expanded clusters while the Woop tensors hold 17
    clusters (one of them the ground and the light). Material variety
    comes from per-instance overrides."""
    b = SceneBuilder()
    ground = b.lambertian((0.6, 0.58, 0.52))
    b.add_quad((-14.0, 0.0, -14.0), (28.0, 0.0, 0.0), (0.0, 0.0, 28.0),
               ground)
    light = b.emissive((40.0, 38.0, 34.0))
    b.add_quad((-2.0, 9.0, -6.0), (4.0, 0.0, 0.0), (0.0, 0.0, 4.0),
               light)

    mats = [
        b.lambertian((0.70, 0.30, 0.25)),
        b.metal((0.85, 0.85, 0.9), 0.08),
        b.ggx((0.9, 0.7, 0.35), roughness=0.25),
    ]
    verts, faces = icosphere(subdivisions, 0.45)
    ts, overrides = instanced_field(grid, mats)
    b.add_instances(verts, faces, mats[0], ts, materials=overrides)
    cam = CameraConfig(position=(0.0, 5.5, 14.0),
                       look_at=(0.0, 0.6, 0.0), vfov_degrees=42.0)
    return b.build(device), cam


def instanced_field(grid: int, mats):
    """The placements of ``instanced_demo``: (transforms, material
    overrides), ``grid``² of each, from a fixed-seed generator."""
    rng = np.random.default_rng(7)
    ts, overrides = [], []
    for i in range(grid):
        for j in range(grid):
            a = float(rng.uniform(0.0, 2.0 * np.pi))
            c, s = np.cos(a), np.sin(a)
            rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            sy = float(rng.uniform(0.6, 1.6))
            sxz = float(rng.uniform(0.7, 1.2))
            scale = np.diag([sxz, sy, sxz])
            t = np.array([
                -9.0 + 18.0 * i / (grid - 1) + float(rng.uniform(-0.3, 0.3)),
                0.45 * sy,
                -9.0 + 18.0 * j / (grid - 1) + float(rng.uniform(-0.3, 0.3)),
            ])
            ts.append(np.concatenate([rot @ scale, t[:, None]], axis=1))
            overrides.append(mats[(i * grid + j) % len(mats)])
    return ts, overrides


def many_lights_demo(grid: int = 12,
                     device=None) -> Tuple[Scene, CameraConfig]:
    """Many-light stress scene: a dark hall lit by a ``grid``×``grid``
    ceiling array of emissive panels (2 triangles each: 288 light rows at
    the default 12, past ``ops.lights._GATHER_MIN``, so the light pick is
    in gather mode) with power-law brightness spread and varied hues, over
    a glossy floor and three probe spheres (Lambertian, metal,
    principled). Panel colors and powers come from a fixed-seed numpy
    generator at build time."""
    rng = np.random.default_rng(20260819)
    b = SceneBuilder()
    floor = b.ggx((0.6, 0.6, 0.62), roughness=0.15)
    b.add_quad((-8.0, 0.0, -8.0), (16.0, 0.0, 0.0), (0.0, 0.0, 16.0),
               floor)
    wall = b.lambertian((0.25, 0.25, 0.27))
    b.add_quad((-8.0, 0.0, -8.0), (16.0, 0.0, 0.0), (0.0, 5.0, 0.0),
               wall)
    b.add_quad((-8.0, 0.0, -8.0), (0.0, 0.0, 16.0), (0.0, 5.0, 0.0),
               wall)
    b.add_quad((8.0, 0.0, 8.0), (-16.0, 0.0, 0.0), (0.0, 5.0, 0.0),
               wall)
    b.add_quad((8.0, 0.0, 8.0), (0.0, 0.0, -16.0), (0.0, 5.0, 0.0),
               wall)
    span, gap = 14.0, 0.25
    cell = span / grid
    for i in range(grid):
        for j in range(grid):
            x = -span / 2 + i * cell
            z = -span / 2 + j * cell
            hue = rng.uniform(0.0, 1.0, 3)
            col = 0.25 + 0.75 * hue / max(float(hue.max()), 1e-6)
            power = 2.0 * float(rng.pareto(2.5) + 0.05)
            mat = b.emissive(tuple(power * col))
            b.add_quad((x + gap / 2, 4.999, z + gap / 2),
                       (cell - gap, 0.0, 0.0), (0.0, 0.0, cell - gap),
                       mat)
    b.add_sphere((-1.6, 0.8, 0.3), 0.8, b.lambertian((0.75, 0.72, 0.68)))
    b.add_sphere((0.9, 0.7, -0.9), 0.7,
                 b.metal((0.9, 0.9, 0.95), fuzz=0.05))
    b.add_sphere((1.7, 0.55, 1.3), 0.55,
                 b.principled((0.2, 0.45, 0.8), metallic=0.0,
                              roughness=0.25))
    cam = CameraConfig(position=(0.0, 2.2, 7.5),
                       look_at=(0.0, 1.0, 0.0), vfov_degrees=45.0)
    return b.build(device), cam


# Emitter-poor outdoor scenes are lit mostly by the sky: a caller that
# leaves the background to the scene takes the gradient for these.
PREFERRED_BACKGROUND: Dict[str, str] = {
    "instanced_demo": "gradient",
}


def preferred_background(name: str) -> str:
    return PREFERRED_BACKGROUND.get(name, "black")
