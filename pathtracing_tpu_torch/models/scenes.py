"""Built-in scenes (the JAX package's ``models/scenes.py``), with the same
geometry, materials, lights and cameras, and its registry (``SCENES``,
``get_scene``, ``PREFERRED_BACKGROUND``) over the scenes the port builds:
the Cornell family (cornell_sphere, cornell_bsdf, cornell_mesh), the
reference sphere, the Veach MIS strips, the checker hero shot, the glass,
frosted, prism, environment-map, principled and spotlight showcases, the
instancing field, the many-light hall and the surface-attribute scenes
(textured_demo, bump_demo, screenlight_demo, with their procedural
textures ``grid_texture`` and ``ripple_normal_map``) and the media
(fog_demo, smoke_demo and fire_demo over the procedural plume
``smoke_density``, sss_demo): all 21 of the JAX registry's scenes.

Cornell geometry: axis-aligned box spanning [-1, 1]³, open toward +z,
camera on the +z axis, an emissive quad centered on the ceiling.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from pathtracing_tpu_torch.models.meshes import smooth_vertex_normals
from pathtracing_tpu_torch.models.scene import Scene, SceneBuilder
from pathtracing_tpu_torch.ops import envmap
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


def textured_cornell_mesh_builder(subdivisions: int,
                                  builder=SceneBuilder) -> SceneBuilder:
    """The unbuilt cornell_mesh scene with a textured, smooth-shaded body:
    the same triangles, added with spherical per-vertex uvs (as
    textured_demo's ball) and area-weighted vertex normals, under a
    grid-textured Lambertian. ``builder`` is the builder class (the JAX
    package's ``SceneBuilder`` builds the same scene)."""
    b = builder()
    _cornell_walls(b)
    body = b.lambertian((0.6, 0.55, 0.45), texture=grid_texture())
    verts, faces = icosphere(subdivisions, radius=0.5)
    b.add_mesh(verts + np.array([0.0, -0.5, 0.0]), faces, body,
               uvs=sphere_uvs(verts), smooth=True)
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


def checker_demo(device=None) -> Tuple[Scene, CameraConfig]:
    """Three spheres (glass, Lambertian, metal) on a procedural checker
    ground under the gradient sky, with no lights: pure BSDF-sampled
    environment lighting."""
    b = SceneBuilder()
    ground = b.checker((0.85, 0.85, 0.85), (0.15, 0.25, 0.15),
                       frequency=1.5)
    b.add_quad((-30.0, 0.0, -30.0), (60.0, 0.0, 0.0), (0.0, 0.0, 60.0),
               ground)
    b.add_sphere((0.0, 1.0, 0.0), 1.0, b.dielectric(1.5))
    b.add_sphere((-2.2, 1.0, 0.0), 1.0, b.lambertian((0.4, 0.2, 0.1)))
    b.add_sphere((2.2, 1.0, 0.0), 1.0, b.metal((0.7, 0.6, 0.5), 0.03))
    cam = CameraConfig(position=(0.0, 1.6, 6.5), look_at=(0.0, 0.9, 0.0),
                       vfov_degrees=35.0)
    return b.build(device), cam


def veach_mis(roughness_floor: float = 0.0,
              device=None) -> Tuple[Scene, CameraConfig]:
    """Veach-style MIS scene: four GGX strips of roughness 0.02 to 0.3
    under three area lights of very different size and similar power.
    ``roughness_floor`` clamps the strip roughness from below."""
    b = SceneBuilder()
    floor = b.lambertian((0.22, 0.22, 0.24))
    back = b.lambertian((0.05, 0.05, 0.06))
    b.add_quad((-12.0, -2.0, -6.0), (24.0, 0.0, 0.0), (0.0, 0.0, 18.0),
               floor)
    b.add_quad((-12.0, -2.0, -6.0), (24.0, 0.0, 0.0), (0.0, 14.0, 0.0),
               back)
    # Three lights, areas 0.04 / 0.36 / 3.24, radiance ~1/area.
    for x, half, rad in [(-3.0, 0.1, (380.0, 330.0, 280.0)),
                         (0.0, 0.3, (42.0, 38.0, 30.0)),
                         (3.0, 0.9, (4.7, 4.2, 3.5))]:
        light = b.emissive(rad)
        b.add_quad((x - half, 5.0, -4.0), (2 * half, 0.0, 0.0),
                   (0.0, 0.0, 2 * half), light)
    strips = [(0.02, -1.1, 0.0, 18.0), (0.08, -0.4, 1.2, 14.0),
              (0.18, 0.4, 2.4, 10.0), (0.30, 1.3, 3.6, 6.0)]
    for rough, y, z, tilt_deg in strips:
        m = b.ggx((0.85, 0.82, 0.78),
                  roughness=max(rough, roughness_floor))
        t = np.radians(tilt_deg)
        depth = 0.9
        # Normal (0, cos t, sin t): up, leaning toward the camera.
        edge_v = (0.0, depth * np.sin(t), -depth * np.cos(t))
        b.add_quad((-5.0, y, z), (10.0, 0.0, 0.0), edge_v, m)
    cam = CameraConfig(position=(0.0, 3.0, 10.0), look_at=(0.0, 1.2, 0.0),
                       vfov_degrees=40.0)
    return b.build(device), cam


def sphere_demo(device=None) -> Tuple[Scene, CameraConfig]:
    """The reference's scene: an r = 0.5 sphere at the origin seen from
    (0, 0, 1), Lambertian under the gradient sky."""
    b = SceneBuilder()
    mat = b.lambertian((0.7, 0.7, 0.7))
    b.add_sphere((0.0, 0.0, 0.0), 0.5, mat)
    cam = CameraConfig(position=(0.0, 0.0, 1.0), look_at=(0.0, 0.0, 0.0),
                       vfov_degrees=90.0)
    return b.build(device), cam


def envmap_demo(device=None) -> Tuple[Scene, CameraConfig]:
    """Image-based lighting: the procedural sun-sky environment (a sun disc
    four orders brighter than the sky, importance-sampled by NEE) over a
    checker ground and a diffuse / glossy / glass sphere row. The
    environment is the only light."""
    b = SceneBuilder()
    ground = b.checker((0.45, 0.45, 0.45), (0.2, 0.25, 0.3), 1.5)
    white = b.lambertian((0.75, 0.72, 0.68))
    gold = b.ggx((1.0, 0.78, 0.34), 0.15)
    glass = b.dielectric(1.5)
    b.add_quad((-20.0, 0.0, -20.0), (40.0, 0.0, 0.0), (0.0, 0.0, 40.0),
               ground)
    b.add_sphere((-1.3, 0.55, 0.0), 0.55, white)
    b.add_sphere((0.0, 0.55, 0.0), 0.55, gold)
    b.add_sphere((1.3, 0.55, 0.0), 0.55, glass)
    b.environment(envmap.sky_texels(
        sun_direction=(0.45, 0.55, -0.55), sky_scale=0.35,
    ))
    cam = CameraConfig(position=(0.0, 1.1, 3.4),
                       look_at=(0.0, 0.55, 0.0), vfov_degrees=38.0)
    return b.build(device), cam


def glass_demo(device=None) -> Tuple[Scene, CameraConfig]:
    """Absorbing glass: three spheres with Beer–Lambert interiors (red,
    amber, blue) and a clear one over a checker floor under the gradient
    sky."""
    b = SceneBuilder()
    ground = b.checker((0.8, 0.8, 0.8), (0.25, 0.25, 0.28), 1.5)
    b.add_quad((-30.0, 0.0, -30.0), (60.0, 0.0, 0.0), (0.0, 0.0, 60.0),
               ground)
    # sigma_a per channel: what the glass removes.
    red = b.dielectric(1.5, absorption=(0.1, 2.2, 2.2))
    amber = b.dielectric(1.5, absorption=(0.05, 0.7, 2.5))
    blue = b.dielectric(1.5, absorption=(2.2, 1.2, 0.08))
    clear = b.dielectric(1.5)
    for x, m in [(-2.4, red), (-0.8, amber), (0.8, blue), (2.4, clear)]:
        b.add_sphere((x, 0.7, 0.0), 0.7, m)
    cam = CameraConfig(position=(0.0, 1.5, 5.2), look_at=(0.0, 0.65, 0.0),
                       vfov_degrees=36.0)
    return b.build(device), cam


def frosted_demo(device=None) -> Tuple[Scene, CameraConfig]:
    """Rough glass: a roughness sweep (0 to 0.4) of glass spheres over a
    checker floor under the gradient sky; the last one also absorbs
    (frosted amber)."""
    b = SceneBuilder()
    ground = b.checker((0.8, 0.8, 0.8), (0.25, 0.25, 0.28), 1.5)
    b.add_quad((-30.0, 0.0, -30.0), (60.0, 0.0, 0.0), (0.0, 0.0, 60.0),
               ground)
    xs = (-2.4, -0.8, 0.8, 2.4)
    mats = (
        b.dielectric(1.5),
        b.dielectric(1.5, roughness=0.08),
        b.dielectric(1.5, roughness=0.25),
        b.dielectric(1.5, roughness=0.4, absorption=(0.05, 0.7, 2.5)),
    )
    for x, m in zip(xs, mats):
        b.add_sphere((x, 0.7, 0.0), 0.7, m)
    cam = CameraConfig(position=(0.0, 1.5, 5.2), look_at=(0.0, 0.65, 0.0),
                       vfov_degrees=36.0)
    return b.build(device), cam


def prism_demo(device=None) -> Tuple[Scene, CameraConfig]:
    """Spectral dispersion: a dense-flint sphere (dispersion 0.12) and a
    plain-glass one under a narrow bright slit light over a white floor."""
    b = SceneBuilder()
    white = b.lambertian((0.85, 0.85, 0.85))
    flint = b.dielectric(ior=1.62, dispersion=0.12)
    plain = b.dielectric(ior=1.62)
    b.add_quad((-3.0, 0.0, -3.0), (6.0, 0.0, 0.0), (0.0, 0.0, 6.0), white)
    b.add_sphere((-0.8, 0.8, 0.0), 0.7, flint)
    b.add_sphere((0.8, 0.8, 0.0), 0.7, plain)
    light = b.emissive((60.0, 60.0, 60.0))
    b.add_quad((-1.6, 3.2, -0.15), (3.2, 0.0, 0.0), (0.0, 0.0, 0.3),
               light)
    cam = CameraConfig(position=(0.0, 2.1, 3.6), look_at=(0.0, 0.5, 0.0),
                       vfov_degrees=45.0)
    return b.build(device), cam


def principled_demo(rows: int = 4, cols: int = 6,
                    device=None) -> Tuple[Scene, CameraConfig]:
    """Material-ball grid: metallic from 0 to 1 down the rows, perceptual
    roughness from 0.04 to 1 across the columns, under the sun-sky
    environment on a checker floor."""
    b = SceneBuilder()
    ground = b.checker((0.5, 0.5, 0.5), (0.25, 0.25, 0.28), 1.2)
    b.add_quad((-30.0, 0.0, -30.0), (60.0, 0.0, 0.0), (0.0, 0.0, 60.0),
               ground)
    r_ball = 0.42
    pitch = 1.0
    base = (0.75, 0.25, 0.2)
    for i in range(rows):
        metallic = i / max(rows - 1, 1)
        for j in range(cols):
            rough = 0.04 + (1.0 - 0.04) * j / max(cols - 1, 1)
            m = b.principled(base, metallic=metallic, roughness=rough)
            x = (j - (cols - 1) / 2.0) * pitch
            z = (i - (rows - 1) / 2.0) * pitch
            b.add_sphere((x, r_ball, z), r_ball, m)
    b.environment(envmap.sky_texels(
        sun_direction=(0.4, 0.6, 0.5), sky_scale=0.35,
    ))
    cam = CameraConfig(position=(0.0, 3.4, 5.6),
                       look_at=(0.0, 0.3, 0.0), vfov_degrees=36.0)
    return b.build(device), cam


def spotlight_demo(device=None) -> Tuple[Scene, CameraConfig]:
    """Delta lights: a spot pooling on a principled ball, a cool point
    light rimming a chrome sphere and a faint directional fill, over a
    brushed-metal (anisotropic GGX) floor. No area light: every photon
    comes from the delta-light estimator."""
    b = SceneBuilder()
    floor = b.ggx((0.55, 0.55, 0.58), roughness=0.3, anisotropy=0.7)
    b.add_quad((-20.0, 0.0, -20.0), (40.0, 0.0, 0.0), (0.0, 0.0, 40.0),
               floor)
    ball = b.principled((0.7, 0.22, 0.15), metallic=0.15, roughness=0.35)
    b.add_sphere((-0.7, 0.5, 0.0), 0.5, ball)
    chrome = b.metal((0.9, 0.9, 0.95), fuzz=0.04)
    b.add_sphere((0.8, 0.4, 0.6), 0.4, chrome)
    b.spot_light((-0.7, 3.5, 0.3), (0.0, -1.0, -0.08),
                 (55.0, 50.0, 42.0), inner_degrees=12.0,
                 outer_degrees=22.0)
    b.point_light((3.0, 1.5, 2.5), (2.5, 3.5, 6.0))
    b.directional_light((-0.4, -1.0, -0.3), (0.25, 0.25, 0.3))
    cam = CameraConfig(position=(0.0, 1.6, 4.5),
                       look_at=(0.0, 0.5, 0.0), vfov_degrees=40.0)
    return b.build(device), cam


def grid_texture(res: int = 256, cells: int = 8,
                 line: float = 0.06) -> np.ndarray:
    """Procedural uv-grid test texture (res, res, 3): warm cells under dark
    grid lines, the hue varying with u so orientation errors show. Linear
    color, no asset file."""
    t = (np.arange(res, dtype=np.float32) + 0.5) / res
    u, v = np.meshgrid(t, t[::-1])   # row 0 = top = v near 1
    fu = u * cells - np.floor(u * cells)
    fv = v * cells - np.floor(v * cells)
    on_line = (np.minimum(fu, 1 - fu) < line / 2) | (
        np.minimum(fv, 1 - fv) < line / 2)
    img = np.empty((res, res, 3), np.float32)
    img[..., 0] = 0.25 + 0.65 * u
    img[..., 1] = 0.55 - 0.25 * u * v
    img[..., 2] = 0.25 + 0.65 * v
    img[on_line] = (0.04, 0.04, 0.05)
    return img


def textured_demo(device=None) -> Tuple[Scene, CameraConfig]:
    """Surface attributes: a uv-grid textured floor and back wall (quad
    uvs), a smooth-shaded textured icosphere (area-weighted vertex normals
    and spherical per-vertex uvs) and a flat-shaded control icosphere,
    under one area light."""
    b = SceneBuilder()
    tex = b.add_texture(grid_texture())
    floor = b.lambertian((1.0, 1.0, 1.0), texture=tex)
    wall = b.lambertian((0.8, 0.85, 1.0), texture=tex)
    plain = b.lambertian((0.55, 0.5, 0.45))
    b.add_quad((-2.0, 0.0, -2.0), (4.0, 0.0, 0.0), (0.0, 0.0, 4.0),
               floor, uv=True)
    b.add_quad((-2.0, 0.0, -2.0), (4.0, 0.0, 0.0), (0.0, 3.0, 0.0),
               wall, uv=True)
    verts, faces = icosphere(2, radius=0.55)
    b.add_mesh(verts + np.array([-0.75, 0.56, 0.2]), faces,
               b.lambertian((1.0, 1.0, 1.0), texture=tex),
               uvs=sphere_uvs(verts),
               normals=smooth_vertex_normals(verts, faces))
    b.add_mesh(verts + np.array([0.75, 0.56, 0.2]), faces, plain)
    light = b.emissive((14.0, 13.5, 12.5))
    b.add_quad((-0.6, 2.95, -0.7), (1.2, 0.0, 0.0), (0.0, 0.0, 1.2),
               light)
    cam = CameraConfig(position=(0.0, 1.25, 3.1),
                       look_at=(0.0, 0.7, 0.0), vfov_degrees=42.0)
    return b.build(device), cam


def sphere_uvs(verts: np.ndarray) -> np.ndarray:
    """Spherical per-vertex uvs (V, 2) of a mesh around the origin, the
    seam at -z: u from the azimuth atan2(x, z), v from the latitude."""
    d = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    return np.stack([
        0.5 + np.arctan2(d[:, 0], d[:, 2]) / (2 * np.pi),
        0.5 + np.arcsin(np.clip(d[:, 1], -1, 1)) / np.pi,
    ], axis=1)


def ripple_normal_map(res: int = 256, rings: float = 6.0,
                      strength: float = 0.75) -> np.ndarray:
    """Procedural tangent-space normal map (res, res, 3): concentric
    ripples around the uv center, encoded 0.5 + 0.5·(t, b, n). Linear
    data, no asset file."""
    t = (np.arange(res, dtype=np.float32) + 0.5) / res
    u, v = np.meshgrid(t, t[::-1])   # row 0 = top = v near 1
    du = u - 0.5
    dv = v - 0.5
    rr = np.sqrt(du * du + dv * dv) + 1e-6
    slope = strength * np.sin(2 * np.pi * rings * rr)
    nx = -slope * du / rr
    ny = -slope * dv / rr
    nz = np.ones_like(nx)
    inv = 1.0 / np.sqrt(nx * nx + ny * ny + nz * nz)
    img = np.stack([nx * inv, ny * inv, nz * inv], axis=-1)
    return (0.5 + 0.5 * img).astype(np.float32)


def bump_demo(device=None) -> Tuple[Scene, CameraConfig]:
    """Normal mapping: a rippled floor (tangent-space map on quad uvs), a
    normal-mapped GGX panel leaning on the wall and a normal-mapped sphere
    (its lat-long frame), under one area light off to the side."""
    b = SceneBuilder()
    nmap = b.add_texture(ripple_normal_map(), srgb=False)
    floor = b.lambertian((0.65, 0.62, 0.58), normal_map=nmap)
    panel = b.ggx((0.9, 0.75, 0.4), roughness=0.18, normal_map=nmap)
    ball = b.lambertian((0.4, 0.5, 0.7), normal_map=nmap)
    plain = b.lambertian((0.55, 0.55, 0.58))
    b.add_quad((-2.0, 0.0, -2.0), (4.0, 0.0, 0.0), (0.0, 0.0, 4.0),
               floor, uv=True)
    b.add_quad((-2.0, 0.0, -2.0), (4.0, 0.0, 0.0), (0.0, 3.0, 0.0),
               plain, uv=True)
    b.add_quad((-1.5, 0.05, -1.6), (1.6, 0.0, 0.35),
               (0.25, 1.6, -0.3), panel, uv=True)
    b.add_sphere((0.85, 0.55, 0.1), 0.55, ball)
    light = b.emissive((16.0, 15.0, 13.0))
    b.add_quad((0.6, 2.9, -0.8), (1.1, 0.0, 0.0), (0.0, 0.0, 1.1),
               light)
    cam = CameraConfig(position=(0.0, 1.35, 3.2),
                       look_at=(0.0, 0.65, 0.0), vfov_degrees=42.0)
    return b.build(device), cam


def screenlight_demo(device=None) -> Tuple[Scene, CameraConfig]:
    """Textured emission: a color-bar "TV screen" panel is the only light;
    its texels tint the directly seen screen and the NEE light on the
    glossy floor (``ops.lights.sample_solid_angle(with_uv=True)``)."""
    b = SceneBuilder()
    card = np.zeros((8, 8, 3), np.float32)
    bars = [(1, 1, 1), (1, 1, 0), (0, 1, 1), (0, 1, 0),
            (1, 0, 1), (1, 0, 0), (0, 0, 1), (0.05, 0.05, 0.05)]
    for i, c in enumerate(bars):
        card[2:, i] = c
    card[:2] = 0.25
    tex = b.add_texture(card)
    floor = b.ggx((0.7, 0.7, 0.72), roughness=0.12)
    b.add_quad((-5.0, 0.0, -3.0), (10.0, 0.0, 0.0), (0.0, 0.0, 8.0),
               floor)
    wall = b.lambertian((0.3, 0.3, 0.32))
    b.add_quad((-5.0, 0.0, -3.0), (10.0, 0.0, 0.0), (0.0, 4.0, 0.0),
               wall)
    screen = b.emissive((10.0, 10.0, 10.0), texture=tex)
    b.add_quad((-1.6, 0.35, -2.2), (3.2, 0.0, 0.0), (0.0, 1.8, 0.0),
               screen, uv=True)
    cam = CameraConfig(position=(0.0, 1.3, 4.2),
                       look_at=(0.0, 0.8, 0.0), vfov_degrees=45.0)
    return b.build(device), cam


def fog_demo(device=None) -> Tuple[Scene, CameraConfig]:
    """Volumetric scattering: the Cornell box filled with a forward-
    scattering homogeneous fog (sigma_s 0.22, sigma_a 0.02, g 0.4) around a
    metal and a diffuse sphere: distance sampling, HG phase scattering,
    the shared medium/surface NEE shadow ray and phase-light MIS."""
    b = SceneBuilder()
    _cornell_walls(b)
    metal = b.metal((0.85, 0.85, 0.9), 0.02)
    diffuse = b.lambertian((0.55, 0.45, 0.35))
    b.add_sphere((-0.45, -0.6, -0.3), 0.4, metal)
    b.add_sphere((0.5, -0.65, 0.25), 0.35, diffuse)
    b.set_fog(sigma_s=0.22, sigma_a=0.02, g=0.4)
    return b.build(device), CORNELL_CAMERA


def smoke_density(res: int = 48, blobs: int = 160,
                  seed: int = 7) -> np.ndarray:
    """Procedural smoke-plume density grid (res, res, res): Gaussian puffs
    along a rising, swirling axis, fading and widening with height, from a
    fixed numpy seed; normalised to max 1."""
    rng_np = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, blobs, dtype=np.float32)
    swirl = 0.22 * (1.0 - t)
    cx = 0.5 + swirl * np.cos(9.0 * t) + 0.03 * rng_np.standard_normal(blobs)
    cy = 0.08 + 0.84 * t + 0.02 * rng_np.standard_normal(blobs)
    cz = 0.5 + swirl * np.sin(9.0 * t) + 0.03 * rng_np.standard_normal(blobs)
    radius = (0.05 + 0.16 * t).astype(np.float32)
    weight = (1.0 - 0.65 * t).astype(np.float32)

    g = (np.arange(res, dtype=np.float32) + 0.5) / res
    gz, gy, gx = np.meshgrid(g, g, g, indexing="ij")
    dens = np.zeros((res, res, res), np.float32)
    for i in range(blobs):
        d2 = ((gx - cx[i]) ** 2 + (gy - cy[i]) ** 2
              + (gz - cz[i]) ** 2) / (radius[i] ** 2)
        dens += weight[i] * np.exp(-3.0 * d2, dtype=np.float32)
    dens -= 0.08 * dens.max()           # carve wispy zero-density edges
    np.maximum(dens, 0.0, out=dens)
    return dens / max(float(dens.max()), 1e-9)


def smoke_demo(device=None) -> Tuple[Scene, CameraConfig]:
    """Heterogeneous media: a procedural smoke plume (``ops.volume`` voxel
    grid, delta tracking) rising through the Cornell box under the ceiling
    light, a metal sphere behind it: free flights through empty and dense
    regions, in-medium NEE with ratio-tracked shadow transmittance, and
    the grid occluding surface NEE."""
    b = SceneBuilder()
    _cornell_walls(b)
    metal = b.metal((0.85, 0.85, 0.9), 0.02)
    b.add_sphere((0.55, -0.6, -0.35), 0.35, metal)
    b.set_volume(
        smoke_density(), bbox_min=(-0.62, -1.0, -0.52),
        bbox_max=(0.38, 0.7, 0.48), sigma_s=14.0, sigma_a=1.2, g=0.25,
    )
    return b.build(device), CORNELL_CAMERA


def fire_demo(device=None) -> Tuple[Scene, CameraConfig]:
    """Emissive media: the smoke plume's dense core emits blackbody-orange
    radiance (emission grid = density²) over a dim gray floor with no
    other light: the flame is the light source, through the collision-
    sampled emission estimator."""
    b = SceneBuilder()
    floor = b.lambertian((0.4, 0.4, 0.42))
    b.add_quad((-3.0, -1.0, -3.0), (6.0, 0.0, 0.0), (0.0, 0.0, 6.0),
               floor)
    dens = smoke_density()
    b.set_volume(
        dens, bbox_min=(-0.62, -1.0, -0.52), bbox_max=(0.38, 0.7, 0.48),
        sigma_s=10.0, sigma_a=6.0, g=0.0,
        emission=dens * dens, emit_color=(14.0, 5.5, 1.6),
    )
    cam = CameraConfig(position=(0.4, 0.2, 3.2), look_at=(-0.1, -0.2, 0.0),
                       vfov_degrees=38.0)
    return b.build(device), cam


def sss_demo(device=None) -> Tuple[Scene, CameraConfig]:
    """Subsurface scattering: four spheres sweeping the interior random
    walk (``SceneBuilder.dielectric(scattering=...)``) over a checker floor
    under the gradient sky: milk, jade, amber wax and a clear-glass
    control."""
    b = SceneBuilder()
    ground = b.checker((0.8, 0.8, 0.8), (0.25, 0.25, 0.28), 1.5)
    b.add_quad((-30.0, 0.0, -30.0), (60.0, 0.0, 0.0), (0.0, 0.0, 60.0),
               ground)
    milk = b.dielectric(1.35, scattering=9.0, scatter_g=0.2,
                        absorption=(0.02, 0.04, 0.12))
    jade = b.dielectric(1.5, scattering=4.0, scatter_g=0.6,
                        absorption=(1.6, 0.12, 1.3))
    wax = b.dielectric(1.45, scattering=2.5, scatter_g=0.0,
                       absorption=(0.05, 0.5, 1.8))
    clear = b.dielectric(1.5)
    for x, m in [(-2.4, milk), (-0.8, jade), (0.8, wax), (2.4, clear)]:
        b.add_sphere((x, 0.7, 0.0), 0.7, m)
    cam = CameraConfig(position=(0.0, 1.5, 5.2), look_at=(0.0, 0.65, 0.0),
                       vfov_degrees=36.0)
    return b.build(device), cam


SCENES: Dict[str, Callable[..., Tuple[Scene, CameraConfig]]] = {
    "cornell_sphere": cornell_sphere,
    "cornell_bsdf": cornell_bsdf,
    "cornell_mesh": cornell_mesh,
    "sphere_demo": sphere_demo,
    "veach_mis": veach_mis,
    "checker_demo": checker_demo,
    "envmap_demo": envmap_demo,
    "textured_demo": textured_demo,
    "bump_demo": bump_demo,
    "prism_demo": prism_demo,
    "glass_demo": glass_demo,
    "frosted_demo": frosted_demo,
    "fog_demo": fog_demo,
    "smoke_demo": smoke_demo,
    "fire_demo": fire_demo,
    "instanced_demo": instanced_demo,
    "principled_demo": principled_demo,
    "spotlight_demo": spotlight_demo,
    "screenlight_demo": screenlight_demo,
    "many_lights_demo": many_lights_demo,
    "sss_demo": sss_demo,
}

# Emitter-free outdoor scenes are lit by the sky alone: a caller that
# leaves the background to the scene takes the gradient for these (black
# would render nothing). Lit interiors and environment-map scenes stay
# black.
PREFERRED_BACKGROUND: Dict[str, str] = {
    "checker_demo": "gradient",
    "sphere_demo": "gradient",
    "glass_demo": "gradient",
    "frosted_demo": "gradient",
    "instanced_demo": "gradient",
    "sss_demo": "gradient",
}


def preferred_background(name: str) -> str:
    return PREFERRED_BACKGROUND.get(name, "black")


def get_scene(name: str, device=None) -> Tuple[Scene, CameraConfig]:
    """The registry scene ``name`` on ``device`` (the card unless the
    caller asks for another device)."""
    if name not in SCENES:
        raise KeyError(f"unknown scene {name!r}; have {sorted(SCENES)}")
    return SCENES[name](device=device)
