"""The Cornell box of P. Shirley's "Ray Tracing: The Rest of Your Life"
(2016, section 2.3): its walls, albedos (0.73 / 0.65,0.05,0.05 /
0.12,0.45,0.15), light (130 x 105 at y = 554, radiance 15) and camera
(from (278, 278, -800) toward (278, 278, 0), vertical field of view 40
degrees), mapped from its 555-unit box onto [-1, 1]^3 (``shirley``), open
toward the camera on +z. A Lambertian icosphere of radius 0.5 on the floor
stands in for the book's two blocks: 20 * 4**subdivisions triangles, the
port's icosphere, generated here so that the benchmark, not the program,
owns its inputs.

``scene_data`` gives the quads, the sphere mesh, the materials and the
camera; ``triangles`` flattens them into the float32 triangle arrays the
reference traces; ``build_port`` hands the same quads and mesh to the
port's ``SceneBuilder``."""

from __future__ import annotations

import numpy as np

WHITE, RED, GREEN, LIGHT, BODY = range(5)

# (kind, albedo, emitted radiance), indexed by the ids above.
MATERIALS = (
    ("lambertian", (0.73, 0.73, 0.73), (0.0, 0.0, 0.0)),
    ("lambertian", (0.65, 0.05, 0.05), (0.0, 0.0, 0.0)),
    ("lambertian", (0.12, 0.45, 0.15), (0.0, 0.0, 0.0)),
    ("emissive", (0.0, 0.0, 0.0), (15.0, 15.0, 15.0)),
    ("lambertian", (0.6, 0.55, 0.45), (0.0, 0.0, 0.0)),
)

BOX = 555.0


def shirley(xs, ys, zs):
    """A point of the book's box in ours: its camera looks along +z with
    x growing to the image's left, ours along -z with x growing right."""
    return (1.0 - 2.0 * xs / BOX, 2.0 * ys / BOX - 1.0, 1.0 - 2.0 * zs / BOX)


def _edge(dx, dy, dz):
    return (2.0 * dx / BOX, 2.0 * dy / BOX, 2.0 * dz / BOX)


# (corner, edge_u, edge_v, material): floor, ceiling, back, left (the
# book's green wall at x = 555), right (its red wall at x = 0), then the
# light, facing down: x from 343 to 213 and z from 332 to 227, at y = 554.
QUADS = (
    ((-1, -1, -1), (2, 0, 0), (0, 0, 2), WHITE),
    ((-1, 1, -1), (0, 0, 2), (2, 0, 0), WHITE),
    ((-1, -1, -1), (0, 2, 0), (2, 0, 0), WHITE),
    ((-1, -1, -1), (0, 0, 2), (0, 2, 0), GREEN),
    ((1, -1, -1), (0, 2, 0), (0, 0, 2), RED),
    (shirley(343, 554, 332), _edge(130, 0, 0), _edge(0, 0, 105), LIGHT),
)

CAMERA = {"position": shirley(278, 278, -800),
          "look_at": shirley(278, 278, 0),
          "up": (0.0, 1.0, 0.0), "vfov_degrees": 40.0}


def icosphere(subdivisions: int, radius: float):
    """(vertices (V, 3) f64, faces (F, 3) i64) of the unit icosahedron
    split ``subdivisions`` times, each new vertex pushed to the sphere;
    vertices are numbered in the order their edges are first met, face by
    face, as the port's loop numbers them."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [(-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
         (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
         (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1)],
        np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)],
        np.int64)
    for _ in range(subdivisions):
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        # Edges in the order the faces meet them: ab, bc, ca per face.
        lo = np.stack([a, b, c], 1).ravel()
        hi = np.stack([b, c, a], 1).ravel()
        keys = np.minimum(lo, hi) * len(verts) + np.maximum(lo, hi)
        uniq, first, inverse = np.unique(keys, return_index=True,
                                         return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(order.size)
        mid_id = (len(verts) + rank)[inverse].reshape(-1, 3)
        m = verts[lo[first[order]]] + verts[hi[first[order]]]
        m /= np.sqrt((m * m).sum(axis=1))[:, None]
        ab, bc, ca = mid_id[:, 0], mid_id[:, 1], mid_id[:, 2]
        faces = np.stack([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                          np.stack([c, ca, bc], 1),
                          np.stack([ab, bc, ca], 1)], 1).reshape(-1, 3)
        verts = np.concatenate([verts, m])
    return verts * radius, faces


def scene_data(config: dict) -> dict:
    """The scene of ``config`` (its ``subdivisions``): quads, the sphere
    mesh (vertices, faces, material), materials and camera."""
    verts, faces = icosphere(int(config["subdivisions"]), 0.5)
    return {"quads": QUADS,
            "mesh": (verts + np.array([0.0, -0.5, 0.0]), faces, BODY),
            "materials": MATERIALS, "camera": CAMERA}


def triangles(data: dict):
    """(v0, e1, e2) float32 (T, 3) and material ids (T,) as the port
    stores them: corners cast from float64, edges subtracted in float32.
    Row order is the builder's (the mesh, then the quads); the reference
    does not depend on it."""
    verts, faces, body = data["mesh"]
    tri = verts[faces]
    corners = [tri[:, 0]], [tri[:, 1]], [tri[:, 2]]
    mats = [np.full(len(faces), body, np.int32)]
    for corner, eu, ev, mat in data["quads"]:
        c, u, v = (np.asarray(x, np.float64) for x in (corner, eu, ev))
        for p0, p1, p2 in ((c, c + u, c + u + v), (c, c + u + v, c + v)):
            for lst, p in zip(corners, (p0, p1, p2)):
                lst.append(p[None])
            mats.append(np.array([mat], np.int32))
    v0, v1, v2 = (np.concatenate(x).astype(np.float32) for x in corners)
    return v0, v1 - v0, v2 - v0, np.concatenate(mats)


def build_port(data: dict, device):
    """The port's Scene of ``data`` on ``device``, through
    ``SceneBuilder``'s public calls."""
    from pathtracing_tpu_torch.models.scene import SceneBuilder

    b = SceneBuilder()
    for kind, albedo, emit in data["materials"]:
        if kind == "emissive":
            b.emissive(emit)
        else:
            b.lambertian(albedo)
    for corner, eu, ev, mat in data["quads"]:
        b.add_quad(corner, eu, ev, mat)
    verts, faces, body = data["mesh"]
    b.add_mesh(verts, faces, body)
    return b.build(device)
