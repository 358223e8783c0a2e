"""A field of instances, the way production scenes hold most of their
geometry: ``grid`` x ``grid`` placements of one icosphere of
``subdivisions`` (20 * 4**subdivisions triangles, stored once), each
turned about y, squashed and jittered from a seeded generator as the
port's ``instanced_field`` places them, on a ground quad under one
emissive quad. Three Lambertian albedos: the sphere's own, kept by every
third placement, and two per-placement overrides. The field, the light
and the camera grow with the grid.

Configuration keys: ``grid``, ``subdivisions``, ``radius`` (the sphere's),
``spacing`` (between placements), ``placement_seed``; and the render keys
every configuration has. Everything is generated here in float64 on the
host, so that the benchmark, not the program, owns its inputs.

``scene_data`` gives the quads, the prototype mesh, the placements, the
materials and the camera; ``build_port`` hands them to the port's
``SceneBuilder`` (``add_instances``); ``reference`` builds the plain
instanced reference (``reference/instanced.py``) of the same data."""

from __future__ import annotations

import numpy as np
import torch

from ptbench import check
from ptbench.reference import instanced
from ptbench.scenes.cornell_mesh import icosphere

GROUND, LIGHT, BODY, RUST, SKY = range(5)

# (kind, albedo, emitted radiance), indexed by the ids above.
MATERIALS = (
    ("lambertian", (0.6, 0.58, 0.52), (0.0, 0.0, 0.0)),
    ("emissive", (0.0, 0.0, 0.0), (40.0, 38.0, 34.0)),
    ("lambertian", (0.70, 0.30, 0.25), (0.0, 0.0, 0.0)),
    ("lambertian", (0.80, 0.62, 0.30), (0.0, 0.0, 0.0)),
    ("lambertian", (0.25, 0.40, 0.65), (0.0, 0.0, 0.0)),
)
OVERRIDES = (-1, RUST, SKY)


def placements(config: dict):
    """(3, 4) float64 object-to-world affines and material overrides (-1
    keeps the sphere's), row by row of the grid."""
    grid, spacing = int(config["grid"]), float(config["spacing"])
    radius = float(config["radius"])
    half = 0.5 * spacing * (grid - 1)
    rng = np.random.default_rng(int(config["placement_seed"]))
    out = []
    for i in range(grid):
        for j in range(grid):
            a = float(rng.uniform(0.0, 2.0 * np.pi))
            c, s = np.cos(a), np.sin(a)
            rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
            sy = float(rng.uniform(0.6, 1.6))
            sxz = float(rng.uniform(0.7, 1.2))
            t = np.array([
                -half + spacing * i + float(rng.uniform(-0.3, 0.3)),
                radius * sy,
                -half + spacing * j + float(rng.uniform(-0.3, 0.3))])
            m = np.concatenate([rot @ np.diag([sxz, sy, sxz]), t[:, None]],
                               axis=1)
            out.append((m, OVERRIDES[(i * grid + j) % len(OVERRIDES)]))
    return out


def scene_data(config: dict) -> dict:
    """The scene of ``config``: quads (corner, edge, edge, material), the
    prototype (vertices, faces, material), placements, materials and
    camera."""
    grid, spacing = int(config["grid"]), float(config["spacing"])
    extent = spacing * (grid - 1)
    ground = 0.5 * extent + 4.0
    height = max(0.5 * extent, 3.0)
    side = 0.44 * height
    quads = (
        ((-ground, 0.0, -ground), (2.0 * ground, 0.0, 0.0),
         (0.0, 0.0, 2.0 * ground), GROUND),
        ((-0.5 * side, height, -0.5 * side), (side, 0.0, 0.0),
         (0.0, 0.0, side), LIGHT),
    )
    verts, faces = icosphere(int(config["subdivisions"]),
                             float(config["radius"]))
    camera = {"position": (0.0, 0.3 * extent + 2.0, 0.75 * extent + 4.0),
              "look_at": (0.0, 0.0, 0.0), "up": (0.0, 1.0, 0.0),
              "vfov_degrees": 42.0}
    return {"quads": quads, "proto": (verts, faces, BODY),
            "placements": placements(config), "materials": MATERIALS,
            "camera": camera}


def _triangles(corners, mats):
    """(v0, e1, e2) float32 (T, 3) and material ids (T,) as the port
    stores them: corners cast from float64, edges subtracted in float32."""
    v0, v1, v2 = (np.asarray(c, np.float64).astype(np.float32)
                  for c in corners)
    return v0, v1 - v0, v2 - v0, np.asarray(mats, np.int32)


def base_triangles(data: dict):
    """The quads' triangles (the ground and the light), two a quad."""
    corners, mats = ([], [], []), []
    for corner, eu, ev, mat in data["quads"]:
        c, u, v = (np.asarray(x, np.float64) for x in (corner, eu, ev))
        for tri in ((c, c + u, c + u + v), (c, c + u + v, c + v)):
            for lst, p in zip(corners, tri):
                lst.append(p)
            mats.append(mat)
    return _triangles(corners, mats)


def proto_triangles(data: dict):
    """The prototype's triangles in object space."""
    verts, faces, body = data["proto"]
    tri = verts[faces]
    return _triangles((tri[:, 0], tri[:, 1], tri[:, 2]),
                      np.full(len(faces), body))


def reference(data: dict, config: dict, device, dtype=torch.float32):
    """The plain reference of the scene: the instanced geometry, lights
    among the base triangles."""
    base = base_triangles(data)
    geo = instanced.prepare(base, [proto_triangles(data)],
                            [(0, m, o) for m, o in data["placements"]],
                            device, dtype)
    return check.Reference(data, base, config, device, dtype, geo=geo)


def build_port(data: dict, device):
    """The port's Scene of ``data`` on ``device``, through
    ``SceneBuilder``'s public calls: the quads, then the prototype stored
    once and placed by ``add_instances``."""
    from pathtracing_tpu_torch.models.scene import SceneBuilder

    b = SceneBuilder()
    for kind, albedo, emit in data["materials"]:
        if kind == "emissive":
            b.emissive(emit)
        else:
            b.lambertian(albedo)
    for corner, eu, ev, mat in data["quads"]:
        b.add_quad(corner, eu, ev, mat)
    verts, faces, body = data["proto"]
    ts = [m for m, _ in data["placements"]]
    overrides = [None if o < 0 else o for _, o in data["placements"]]
    b.add_instances(verts, faces, body, ts, materials=overrides)
    return b.build(device)
