"""Scene representation (the JAX package's ``models/scene.py``, as far as
the flagship path needs it): spheres, triangles, cluster tables, the
material table and the area-light table, as tensors on one device.

Layout invariants (as in the JAX package):
  * ≥ 1 sphere and ≥ 1 triangle always exist (degenerate, mat_id 0, never
    hit) so gathers and reductions never see zero-length axes.
  * Triangles are stored in the leaf order of the leaf-size-4 SAH BVH, the
    order the light table follows.
  * Materials are a 4-column table indexed by per-primitive int32 ids.

``intersect_batch``/``occluded_batch`` run the sphere pre-pass, then route
the triangles to ``ops.cluster_trace``: the CUDA kernels for
``traversal="cluster_cuda"`` and their plain torch versions for
``"cluster_torch"``. ``scene_from_numpy`` takes the JAX package's Scene
fields as numpy arrays, so one scene can feed both packages.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pathtracing_tpu_torch.ops import bvh as bvh_ops
from pathtracing_tpu_torch.ops import clusters as cluster_ops
from pathtracing_tpu_torch.ops import cluster_trace, intersect, lights, linalg
from pathtracing_tpu_torch.ops import materials
from pathtracing_tpu_torch.utils.config import resolve_device


class Scene(NamedTuple):
    sph_center: torch.Tensor   # (S, 3) f32
    sph_radius: torch.Tensor   # (S,)   f32
    sph_mat: torch.Tensor      # (S,)   i32
    tri_v0: torch.Tensor       # (T, 3) f32
    tri_e1: torch.Tensor       # (T, 3) f32
    tri_e2: torch.Tensor       # (T, 3) f32
    tri_mat: torch.Tensor      # (T,)   i32
    mat_type: torch.Tensor     # (K,)   i32
    mat_albedo: torch.Tensor   # (K, 3) f32
    mat_param: torch.Tensor    # (K,)   f32
    mat_emit: torch.Tensor     # (K, 3) f32
    clusters: cluster_ops.ClusterSet
    lights: lights.LightTable

    @property
    def material_table(self):
        return (self.mat_type, self.mat_albedo, self.mat_param, self.mat_emit)


class Hit(NamedTuple):
    """Per-ray hit record."""

    t: torch.Tensor         # distance (> 1e37 or inf on a miss)
    position: torch.Tensor  # (R, 3)
    normal: torch.Tensor    # (R, 3) unit, flipped to face against the ray
    mat_id: torch.Tensor    # int32, 0 on a miss (mask with .valid)
    front: torch.Tensor     # bool, geometric front side
    valid: torch.Tensor     # bool
    tri: torch.Tensor       # bool, hit a triangle (vs a sphere)
    slot: torch.Tensor      # int32 padded cluster slot (-1 for spheres/misses)


# Scene features of the JAX package that the port does not carry yet,
# with the ROADMAP queue-A item that ports each.
_UNPORTED_FIELDS = {
    "pages": "item 15 (big scenes)",
    "env": "item 11 (envmap)",
    "attr_uv": "item 12 (surface attributes)",
    "attr_shn": "item 12 (surface attributes)",
    "slot_to_tri": "item 12 (surface attributes)",
    "attr_pack": "item 12 (surface attributes)",
    "textures": "item 12 (surface attributes)",
    "mat_tex": "item 12 (surface attributes)",
    "mat_absorb": "item 11 (materials)",
    "mat_interior": "item 16 (media)",
    "fog": "item 16 (media)",
    "mat_param2": "item 11 (materials)",
    "mat_ntex": "item 12 (surface attributes)",
    "mat_disp": "item 11 (materials)",
    "mat_metallic": "item 11 (materials)",
    "mat_clearcoat": "item 11 (materials)",
    "mat_mrtex": "item 12 (surface attributes)",
    "instances": "item 14 (instancing)",
    "mat_aniso": "item 11 (materials)",
    "delta": "item 11 (delta lights)",
    "vol": "item 16 (media)",
}

_FLOAT_FIELDS = ("sph_center", "sph_radius", "tri_v0", "tri_e1", "tri_e2",
                 "mat_albedo", "mat_param", "mat_emit")
_INT_FIELDS = ("sph_mat", "tri_mat", "mat_type")


def _fields(x):
    return x._asdict() if hasattr(x, "_asdict") else dict(x)


def scene_from_numpy(arrays, device) -> Scene:
    """The port's Scene from the JAX package's Scene fields as numpy
    arrays (a dict, or the Scene NamedTuple mapped through ``np.asarray``;
    ``clusters`` and ``lights`` may be dicts or NamedTuples). Fields the
    port does not carry must be None; the JAX BVH is ignored."""
    arrays = _fields(arrays)
    for name, item in _UNPORTED_FIELDS.items():
        if arrays.get(name) is not None:
            raise NotImplementedError(
                f"scene field {name!r} is not ported yet (ROADMAP queue A "
                f"{item})"
            )
    device = torch.device(device)

    def dev(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    cl = _fields(arrays["clusters"])
    li = _fields(arrays["lights"])
    for name in ("kind", "uv0", "uv_e1", "uv_e2", "tex", "packed"):
        if li.get(name) is not None:
            raise NotImplementedError(
                f"light-table column {name!r} is not ported yet (ROADMAP "
                "queue A item 11)"
            )
    fields = {n: dev(arrays[n], torch.float32) for n in _FLOAT_FIELDS}
    fields.update({n: dev(arrays[n], torch.int32) for n in _INT_FIELDS})
    return Scene(
        clusters=cluster_ops.ClusterSet(
            aabb_min=dev(cl["aabb_min"], torch.float32),
            aabb_max=dev(cl["aabb_max"], torch.float32),
            woop=dev(cl["woop"], torch.float32),
            normal=dev(cl["normal"], torch.float32),
            mat=dev(cl["mat"], torch.int32),
        ),
        lights=lights.LightTable(
            **{n: dev(li[n], torch.float32) for n in lights.LightTable._fields}
        ),
        **fields,
    )


class SceneBuilder:
    """Host-side scene assembly (numpy), as the JAX package's
    ``SceneBuilder``; ``build`` uploads the tensors to one device."""

    def __init__(self) -> None:
        self._sph = []         # (center, radius, mat)
        self._tri = []         # (v0, v1, v2, mat)
        self._tri_chunks = []  # (v0 (k,3), v1, v2, mat (k,)) arrays
        self._mat = []         # (type, albedo, param, emit)

    # -- materials ---------------------------------------------------------
    def add_material(self, mtype, albedo=(0.0, 0.0, 0.0), param=0.0,
                     emit=(0.0, 0.0, 0.0)) -> int:
        self._mat.append((int(mtype), tuple(albedo), float(param),
                          tuple(emit)))
        return len(self._mat) - 1

    def lambertian(self, albedo) -> int:
        return self.add_material(materials.TYPE_LAMBERTIAN, albedo)

    def metal(self, albedo, fuzz=0.0) -> int:
        return self.add_material(materials.TYPE_METAL, albedo, fuzz)

    def dielectric(self, ior=1.5, tint=(1.0, 1.0, 1.0)) -> int:
        """Smooth dielectric; absorption, roughness, dispersion and
        scattering are not ported yet (ROADMAP queue A items 11, 16)."""
        return self.add_material(materials.TYPE_DIELECTRIC, tint, ior)

    def emissive(self, radiance) -> int:
        return self.add_material(materials.TYPE_EMISSIVE, (0.0, 0.0, 0.0),
                                 0.0, radiance)

    # -- geometry ----------------------------------------------------------
    def add_sphere(self, center, radius, mat_id) -> None:
        self._sph.append((tuple(center), float(radius), int(mat_id)))

    def add_triangle(self, v0, v1, v2, mat_id) -> None:
        self._tri.append((tuple(v0), tuple(v1), tuple(v2), int(mat_id)))

    def add_quad(self, corner, edge_u, edge_v, mat_id) -> None:
        """Parallelogram as two triangles (Cornell walls)."""
        c = np.asarray(corner, np.float64)
        u = np.asarray(edge_u, np.float64)
        v = np.asarray(edge_v, np.float64)
        self.add_triangle(c, c + u, c + u + v, mat_id)
        self.add_triangle(c, c + u + v, c + v, mat_id)

    def add_mesh(self, vertices: np.ndarray, faces: np.ndarray,
                 mat_id) -> None:
        """Indexed triangle mesh: vertices (V,3) float, faces (F,3) int,
        stored as one array chunk (UVs and shading normals are not ported
        yet: ROADMAP queue A item 12)."""
        vertices = np.asarray(vertices, np.float64)
        faces = np.asarray(faces, np.int64)
        tri = vertices[faces]  # (F, 3, 3)
        self._tri_chunks.append((
            tri[:, 0], tri[:, 1], tri[:, 2],
            np.full(tri.shape[0], int(mat_id), np.int32),
        ))

    # -- finalize ----------------------------------------------------------
    def build(self, device=None) -> Scene:
        """Build the scene's tables on the host and upload them to
        ``device`` (the card unless the caller asks for another device)."""
        device = resolve_device(device)
        if not self._mat:
            self.lambertian((0.5, 0.5, 0.5))

        far = (3.0e38, 3.0e38, 3.0e38)
        sph = self._sph or [(far, 0.0, 0)]
        sph_center = np.array([s[0] for s in sph], np.float32)
        sph_radius = np.array([s[1] for s in sph], np.float32)
        sph_mat = np.array([s[2] for s in sph], np.int32)

        chunks = list(self._tri_chunks)
        if self._tri:
            t = self._tri
            chunks.append((
                np.array([x[0] for x in t], np.float64),
                np.array([x[1] for x in t], np.float64),
                np.array([x[2] for x in t], np.float64),
                np.array([x[3] for x in t], np.int32),
            ))
        if not chunks:
            z = np.zeros((1, 3), np.float64)
            chunks = [(z, z, z, np.zeros(1, np.int32))]
        v0 = np.concatenate([c[0] for c in chunks]).astype(np.float32)
        v1 = np.concatenate([c[1] for c in chunks]).astype(np.float32)
        v2 = np.concatenate([c[2] for c in chunks]).astype(np.float32)
        tri_mat = np.concatenate([c[3] for c in chunks]).astype(np.int32)
        e1 = v1 - v0
        e2 = v2 - v0

        # The leaf-size-4 BVH only fixes the stored triangle order (which
        # the light table, and so the light picks, follow).
        _, perm = bvh_ops.build_bvh(v0, e1, e2)
        cl, _, _ = cluster_ops.build_clusters(v0, e1, e2, tri_mat)
        if cl.woop.shape[0] > cluster_trace.DNF_MAX_CLUSTERS:
            raise NotImplementedError(
                f"{cl.woop.shape[0]} clusters exceed the flat kernels' "
                f"budget ({cluster_trace.DNF_MAX_CLUSTERS}); paged scenes "
                "are not ported yet (ROADMAP queue A item 15)"
            )
        v0, e1, e2, tri_mat = v0[perm], e1[perm], e2[perm], tri_mat[perm]

        mat_type = np.array([m[0] for m in self._mat], np.int32)
        mat_albedo = np.array([m[1] for m in self._mat], np.float32)
        mat_param = np.array([m[2] for m in self._mat], np.float32)
        mat_emit = np.array([m[3] for m in self._mat], np.float32)

        def dev(x, dtype=torch.float32):
            return torch.as_tensor(x, dtype=dtype, device=device)

        return Scene(
            sph_center=dev(sph_center), sph_radius=dev(sph_radius),
            sph_mat=dev(sph_mat, torch.int32),
            tri_v0=dev(v0), tri_e1=dev(e1), tri_e2=dev(e2),
            tri_mat=dev(tri_mat, torch.int32),
            mat_type=dev(mat_type, torch.int32), mat_albedo=dev(mat_albedo),
            mat_param=dev(mat_param), mat_emit=dev(mat_emit),
            clusters=cluster_ops.ClusterSet(
                aabb_min=dev(cl.aabb_min), aabb_max=dev(cl.aabb_max),
                woop=dev(cl.woop), normal=dev(cl.normal),
                mat=dev(cl.mat, torch.int32),
            ),
            lights=lights.build_light_table(
                v0, v0 + e1, v0 + e2, tri_mat, mat_type, mat_emit,
                materials.TYPE_EMISSIVE, device,
                sph_center=sph_center, sph_radius=sph_radius,
                sph_mat=sph_mat,
            ),
        )


def has_motion(scene: Scene) -> bool:
    """Motion-blurred instances are not ported yet: always False."""
    return False


def uses_mips(scene: Scene) -> bool:
    """Texture mip pyramids are not ported yet: always False."""
    return False


def uses_dnf(scene: Scene) -> bool:
    """True when cluster queries route to the flat cluster kernels (every
    scene the port's builder accepts)."""
    return (scene.clusters is not None and scene.clusters.woop.shape[0]
            <= cluster_trace.DNF_MAX_CLUSTERS)


def _sphere_pass(scene: Scene, origin, direction):
    """(R, S) ray–sphere distances for a ray batch (brute force over the
    small sphere set)."""
    return intersect.ray_sphere(
        origin[:, None, :], direction[:, None, :],
        scene.sph_center[None, :, :], scene.sph_radius[None, :],
    )


def _route(traversal: str, torch_fn, kernel_fn):
    if traversal == "cluster_torch":
        return torch_fn
    if traversal == "cluster_cuda":
        return kernel_fn
    raise ValueError(f"unknown traversal mode: {traversal!r}")


def occluded_batch(scene: Scene, origin, direction, t_max,
                   traversal: str, active=None):
    """Any-hit occlusion for a (R, 3) ray batch: True where any primitive
    lies strictly inside (T_MIN, t_max). Lanes the sphere pass already
    occluded, and inactive lanes, get a zero cap so the cluster sweep
    skips them (the result ORs the sphere answer back in)."""
    ts = _sphere_pass(scene, origin, direction)
    occ_sph = torch.min(ts, dim=1).values < t_max
    if active is not None:
        occ_sph = occ_sph & active
    cap = t_max
    if active is not None:
        cap = torch.where(active, cap, 0.0)
    cap = torch.where(occ_sph, 0.0, cap)
    fn = _route(traversal, cluster_trace.occluded_torch,
                cluster_trace.occluded)
    occ_tri = fn(scene.clusters, origin, direction, cap)
    return occ_sph | occ_tri


def intersect_batch(scene: Scene, origin, direction, traversal: str,
                    active=None, t_max=None) -> Hit:
    """Closest hit for a whole (R, 3) ray batch. Spheres first (their best
    t culls the cluster sweep); ``active`` (optional (R,) bool) gives dead
    lanes ``t_init = 0``, and their Hit fields are garbage the callers
    mask."""
    ts = _sphere_pass(scene, origin, direction)               # (R, S)
    sph_t, sph_idx = torch.min(ts, dim=1)
    t_init = torch.where(torch.isfinite(sph_t), sph_t, 3.0e38)
    if t_max is not None:
        t_init = torch.minimum(t_init, t_max)
    if active is not None:
        t_init = torch.where(active, t_init, 0.0)

    fn = _route(traversal, cluster_trace.trace_torch, cluster_trace.trace)
    tri_t, slot, n_tri, mat_tri = fn(scene.clusters, origin, direction,
                                     t_init)

    hit_tri = slot >= 0
    t = torch.where(hit_tri, tri_t, sph_t)
    valid = torch.isfinite(t) & (t < 1.0e37)
    position = origin + t[:, None] * direction

    safe_sph = torch.clamp(sph_idx, max=scene.sph_center.shape[0] - 1)
    n_sph = (position - scene.sph_center[safe_sph]) / torch.clamp(
        scene.sph_radius[safe_sph], min=1e-12
    )[:, None]
    n_geo = torch.where(hit_tri[:, None], n_tri, n_sph)

    front = linalg.dot(direction, n_geo) < 0.0
    normal = torch.where(front[:, None], 1.0, -1.0) * n_geo

    mat_id = torch.where(hit_tri, mat_tri, scene.sph_mat[safe_sph])
    mat_id = torch.where(valid, mat_id, 0).to(torch.int32)
    return Hit(
        t=t, position=position, normal=normal, mat_id=mat_id, front=front,
        valid=valid, tri=hit_tri & valid,
        slot=torch.where(hit_tri & valid, slot, -1).to(torch.int32),
    )
