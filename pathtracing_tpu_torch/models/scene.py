"""Scene representation (the JAX package's ``models/scene.py``, as far as
the ported paths need it): spheres, triangles, cluster tables, shared-
geometry instances, the material table with its optional columns, the
area-light table, delta lights and the environment map, as tensors on
one device.

Layout invariants (as in the JAX package):
  * ≥ 1 sphere and ≥ 1 triangle always exist (degenerate, mat_id 0, never
    hit) so gathers and reductions never see zero-length axes.
  * Triangles are stored in the leaf order of the leaf-size-4 SAH BVH, the
    order the light table follows.
  * Materials are a 4-column table indexed by per-primitive int32 ids.

``intersect_batch``/``occluded_batch`` run the sphere pre-pass, then route
the triangles to ``ops.cluster_trace``: the CUDA kernels for
``traversal="cluster_cuda"`` and their plain torch versions for
``"cluster_torch"``. Under either name, as in the JAX package: a scene
with ``instances`` goes to the instanced pair, a paged scene (``pages``)
to the paged pair (closest hit and any hit), a flat scene of at most
``DNF_MAX_CLUSTERS`` clusters to the flat pair, and a larger unpaged one
to the cluster-tree walk. ``scene_from_numpy`` takes the JAX package's
Scene fields as numpy arrays, so one scene can feed both packages.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pathtracing_tpu_torch.ops import bvh as bvh_ops
from pathtracing_tpu_torch.ops import clusters as cluster_ops
from pathtracing_tpu_torch.ops import cluster_trace, envmap, intersect
from pathtracing_tpu_torch.ops import lights, linalg
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
    # (K,) f32 metallic column of TYPE_PRINCIPLED materials (mat_param
    # carries their perceptual roughness); None unless some material is
    # principled, and the lobe is then never built.
    mat_metallic: torch.Tensor = None
    # (K, 2) f32 clearcoat column [strength, roughness] of principled
    # materials; None unless some material has clearcoat > 0.
    mat_clearcoat: torch.Tensor = None
    # Shared-geometry instancing (ops.clusters.InstanceSet): expanded
    # per-instance world boxes and transforms over the PROTOTYPE clusters
    # stored in ``clusters`` (base geometry rides along as identity
    # entries). When set, every cluster query goes through the instanced
    # kernels. None for ordinary scenes.
    instances: cluster_ops.InstanceSet = None
    # HBM pages (ops.clusters.PageSet) of a scene past the flat kernels'
    # budget; ``clusters`` is then in page order, padded to whole pages.
    pages: cluster_ops.PageSet = None
    # Image-based environment light (ops.envmap.EnvMap): escaped rays look
    # it up and NEE samples it. None falls back to the static background.
    env: envmap.EnvMap = None
    # Point, spot and directional lights (ops.lights.DeltaLights), lit by
    # NEE alone. None for scenes without them.
    delta: lights.DeltaLights = None
    # (K, 3) f32 interior Beer–Lambert sigma_a of dielectrics; None unless
    # some material absorbs (the megakernel then carries a per-path
    # medium).
    mat_absorb: torch.Tensor = None
    # (K,) f32 rough dielectric GGX alpha (mat_param is its IOR); None
    # unless some material is TYPE_ROUGH_DIELECTRIC.
    mat_param2: torch.Tensor = None
    # (K,) f32 IOR spread (blue − red) of dispersive dielectrics; None
    # unless some dielectric disperses.
    mat_disp: torch.Tensor = None
    # (K,) f32 GGX anisotropy in [0, 1); None unless some material is
    # anisotropic.
    mat_aniso: torch.Tensor = None

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
    "attr_uv": "item 12 (surface attributes)",
    "attr_shn": "item 12 (surface attributes)",
    "slot_to_tri": "item 12 (surface attributes)",
    "attr_pack": "item 12 (surface attributes)",
    "textures": "item 12 (surface attributes)",
    "mat_tex": "item 12 (surface attributes)",
    "mat_interior": "item 16 (media)",
    "fog": "item 16 (media)",
    "mat_ntex": "item 12 (surface attributes)",
    "mat_mrtex": "item 12 (surface attributes)",
    "vol": "item 16 (media)",
}

_FLOAT_FIELDS = ("sph_center", "sph_radius", "tri_v0", "tri_e1", "tri_e2",
                 "mat_albedo", "mat_param", "mat_emit")
_INT_FIELDS = ("sph_mat", "tri_mat", "mat_type")
_CLUSTER_DTYPES = {"mat": torch.int32, "node_meta": torch.int32,
                   "oct_links": torch.int32}


def _fields(x):
    return x._asdict() if hasattr(x, "_asdict") else dict(x)


def scene_from_numpy(arrays, device) -> Scene:
    """The port's Scene from the JAX package's Scene fields as numpy
    arrays (a dict, or the Scene NamedTuple mapped through ``np.asarray``;
    ``clusters``, ``lights``, ``instances`` and ``pages`` may be dicts or
    NamedTuples). Fields the port does not carry must be None; the JAX BVH
    and the TPU lookahead kernel's ``cand_box`` blocks are dropped. A
    cluster set without a tree gets one (``clusters.with_tree``)."""
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
    for name in ("uv0", "uv_e1", "uv_e2", "tex"):
        if li.get(name) is not None:
            raise NotImplementedError(
                f"light-table column {name!r} (textured emitters) is not "
                "ported yet (ROADMAP queue A item 12)"
            )

    def opt(table, name, dtype):
        x = table.get(name)
        return None if x is None else dev(x, dtype)

    # The flat kernels walk the set's cluster tree: a set that comes
    # without one gets one, built over its real clusters.
    host_cl = cluster_ops.with_tree(cluster_ops.ClusterSet(**{
        f: None if cl.get(f) is None else np.asarray(cl[f])
        for f in cluster_ops.ClusterSet._fields}))
    fields = {n: dev(arrays[n], torch.float32) for n in _FLOAT_FIELDS}
    fields.update({n: dev(arrays[n], torch.int32) for n in _INT_FIELDS})
    instances = None
    if arrays.get("instances") is not None:
        it = _fields(arrays["instances"])
        first, lo, hi = cluster_ops.placement_boxes(
            it["inst_id"], it["aabb_min"], it["aabb_max"])
        instances = cluster_ops.InstanceSet(
            cmap=dev(it["cmap"], torch.int32),
            xform=dev(it["xform"], torch.float32),
            aabb_min=dev(it["aabb_min"], torch.float32),
            aabb_max=dev(it["aabb_max"], torch.float32),
            inst_id=dev(it["inst_id"], torch.int32),
            imat=opt(it, "imat", torch.int32),
            fw0=opt(it, "fw0", torch.float32),
            fw1=opt(it, "fw1", torch.float32),
            inst_first=dev(first, torch.int32),
            inst_min=dev(lo, torch.float32),
            inst_max=dev(hi, torch.float32),
        )
    pages = None
    if arrays.get("pages") is not None:
        pg = _fields(arrays["pages"])
        node_meta = dev(pg["node_meta"], torch.int32)
        pages = cluster_ops.PageSet(
            node_box=dev(pg["node_box"], torch.float32),
            node_meta=node_meta,
            oct_links=dev(pg["oct_links"], torch.int32),
            n_real=(node_meta[:, 1] >= 0).sum(dim=1, dtype=torch.int32),
        )
    light_cols = {n: dev(li[n], torch.float32)
                  for n in lights.LightTable._fields
                  if n not in ("kind", "packed")}
    env = delta = None
    if arrays.get("env") is not None:
        ev = _fields(arrays["env"])
        env = envmap.EnvMap(**{n: dev(ev[n], torch.float32)
                               for n in envmap.EnvMap._fields})
    if arrays.get("delta") is not None:
        dl = _fields(arrays["delta"])
        delta = lights.DeltaLights(**{
            n: dev(dl[n], torch.int32 if n == "kind" else torch.float32)
            for n in lights.DeltaLights._fields})
    return Scene(
        env=env, delta=delta,
        mat_absorb=opt(arrays, "mat_absorb", torch.float32),
        mat_param2=opt(arrays, "mat_param2", torch.float32),
        mat_disp=opt(arrays, "mat_disp", torch.float32),
        mat_aniso=opt(arrays, "mat_aniso", torch.float32),
        mat_metallic=opt(arrays, "mat_metallic", torch.float32),
        mat_clearcoat=opt(arrays, "mat_clearcoat", torch.float32),
        instances=instances, pages=pages,
        clusters=cluster_ops.ClusterSet(*(
            None if x is None else dev(x, _CLUSTER_DTYPES.get(f,
                                                             torch.float32))
            for f, x in zip(cluster_ops.ClusterSet._fields, host_cl))),
        lights=lights.LightTable(
            kind=opt(li, "kind", torch.int32),
            packed=opt(li, "packed", torch.float32),
            **light_cols,
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
        self._mat_metallic = []  # per-material metallic (principled)
        self._mat_cc = []      # per-material (clearcoat, coat roughness)
        self._mat_absorb = []  # per-material interior sigma_a (r, g, b)
        self._mat_param2 = []  # per-material second scalar (rough alpha)
        self._mat_disp = []    # per-material IOR dispersion (blue - red)
        self._mat_aniso = []   # per-material GGX anisotropy [0, 1)
        # (v0, e1, e2, mats, [(3,4) transforms], [imat], [motion (3,4)])
        self._protos = []
        self._delta = []       # delta-light spec dicts (ops.lights)
        self._env = None       # (H, W, 3) texels or an ops.envmap.EnvMap

    # -- lights ------------------------------------------------------------
    def point_light(self, position, intensity) -> None:
        """Zero-extent point emitter: ``intensity`` is radiant W/sr
        (received radiance falls off as 1/d²)."""
        self._delta.append({
            "type": "point", "position": tuple(map(float, position)),
            "intensity": tuple(map(float, intensity)),
        })

    def spot_light(self, position, direction, intensity,
                   inner_degrees: float = 20.0,
                   outer_degrees: float = 30.0) -> None:
        """Point emitter restricted to a cone around ``direction`` with a
        smoothstep falloff between the inner and outer half-angles."""
        if inner_degrees > outer_degrees:
            raise ValueError("spot inner cone must be <= outer cone")
        self._delta.append({
            "type": "spot", "position": tuple(map(float, position)),
            "direction": tuple(map(float, direction)),
            "intensity": tuple(map(float, intensity)),
            "inner_degrees": float(inner_degrees),
            "outer_degrees": float(outer_degrees),
        })

    def directional_light(self, direction, irradiance) -> None:
        """Sun-style parallel light: ``direction`` is the travel direction,
        ``irradiance`` the power received by a surface facing it (no
        falloff; shadows query toward t = 1e7)."""
        self._delta.append({
            "type": "directional",
            "direction": tuple(map(float, direction)),
            "irradiance": tuple(map(float, irradiance)),
        })

    def environment(self, texels_or_envmap) -> None:
        """Attach an image-based environment light: a (H, W, 3) lat-long
        radiance grid (its tables are built with the scene) or a built
        ``ops.envmap.EnvMap`` (moved to the scene's device)."""
        self._env = (texels_or_envmap
                     if isinstance(texels_or_envmap, envmap.EnvMap)
                     else np.asarray(texels_or_envmap, np.float32))

    # -- materials ---------------------------------------------------------
    def add_material(self, mtype, albedo=(0.0, 0.0, 0.0), param=0.0,
                     emit=(0.0, 0.0, 0.0), absorption=(0.0, 0.0, 0.0),
                     param2=0.0, dispersion=0.0, metallic=0.0,
                     clearcoat=0.0, clearcoat_roughness=0.1,
                     anisotropy=0.0, scattering=0.0) -> int:
        """``absorption``: interior Beer–Lambert sigma_a per channel (on
        dielectrics: paths inside lose exp(−sigma_a · distance));
        ``param2``: the rough dielectric's GGX alpha; ``dispersion``: the
        IOR spread of a smooth dielectric; ``anisotropy`` in [0, 1): the
        GGX conductor's. Interior scattering (``scattering`` > 0) is not
        ported yet (ROADMAP queue A item 16)."""
        if scattering > 0.0:
            raise NotImplementedError(
                "interior scattering (subsurface media) is not ported yet "
                "(ROADMAP queue A item 16)"
            )
        if not 0.0 <= anisotropy < 1.0:
            raise ValueError("anisotropy must be in [0, 1)")
        self._mat.append((int(mtype), tuple(albedo), float(param),
                          tuple(emit)))
        self._mat_absorb.append(tuple(float(x) for x in absorption))
        self._mat_param2.append(float(param2))
        self._mat_disp.append(float(dispersion))
        self._mat_metallic.append(float(metallic))
        self._mat_cc.append((float(clearcoat), float(clearcoat_roughness)))
        self._mat_aniso.append(float(anisotropy))
        return len(self._mat) - 1

    def lambertian(self, albedo) -> int:
        return self.add_material(materials.TYPE_LAMBERTIAN, albedo)

    def metal(self, albedo, fuzz=0.0) -> int:
        return self.add_material(materials.TYPE_METAL, albedo, fuzz)

    def ggx(self, f0, roughness=0.1, anisotropy=0.0) -> int:
        """Microfacet conductor: f0 = Fresnel normal reflectance,
        roughness = GGX alpha. Unlike ``metal`` it has a real pdf, so
        glossy vertices take part in NEE/MIS. ``anisotropy`` in [0, 1)
        stretches the NDF along the surface tangent (Disney aspect
        convention): brushed-metal highlights."""
        return self.add_material(materials.TYPE_GGX, f0, roughness,
                                 anisotropy=anisotropy)

    def principled(self, base_color, metallic=0.0, roughness=0.5,
                   clearcoat=0.0, clearcoat_roughness=0.1) -> int:
        """Metallic-roughness material: diffuse + GGX specular with
        F0 = lerp(0.04, base_color, metallic); ``roughness`` is perceptual
        (GGX alpha = roughness²). Fully NEE/MIS-eligible. ``clearcoat``
        adds a second GGX layer at fixed IOR 1.5 with its own
        ``clearcoat_roughness``; the layer's Fresnel attenuates the base
        lobes. Texture, normal and metallic-roughness maps are not ported
        yet (ROADMAP queue A item 12)."""
        return self.add_material(
            materials.TYPE_PRINCIPLED, base_color, roughness,
            metallic=metallic, clearcoat=clearcoat,
            clearcoat_roughness=clearcoat_roughness,
        )

    def dielectric(self, ior=1.5, tint=(1.0, 1.0, 1.0),
                   absorption=(0.0, 0.0, 0.0), roughness=0.0,
                   dispersion=0.0, scattering=0.0) -> int:
        """``absorption``: interior sigma_a (Beer–Lambert), e.g.
        (0.1, 2.0, 2.0) is red glass. ``roughness`` > 0 selects the
        microfacet (Walter 2007) glass with GGX alpha = roughness.
        ``dispersion``: IOR spread blue − red, smooth dielectrics only;
        a path splits to one RGB channel at its first dispersive hit.
        ``scattering`` (interior media) is not ported yet (ROADMAP queue A
        item 16)."""
        if roughness > 0.0:
            return self.add_material(
                materials.TYPE_ROUGH_DIELECTRIC, tint, ior,
                absorption=absorption, param2=roughness,
                scattering=scattering,
            )
        return self.add_material(
            materials.TYPE_DIELECTRIC, tint, ior, absorption=absorption,
            dispersion=dispersion, scattering=scattering,
        )

    def emissive(self, radiance) -> int:
        return self.add_material(materials.TYPE_EMISSIVE, (0.0, 0.0, 0.0),
                                 0.0, radiance)

    def checker(self, color1, color2, frequency: float = 3.0) -> int:
        """Procedural two-tone Lambertian (world-space checkerboard); the
        emit columns carry the second color, param the frequency."""
        return self.add_material(materials.TYPE_CHECKER, color1, frequency,
                                 color2)

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

    def add_instances(self, vertices: np.ndarray, faces: np.ndarray,
                      mat_id, transforms, materials=None,
                      motion_transforms=None) -> None:
        """Instance one prototype mesh many times by object→world affine
        transforms — shared geometry (``ops.clusters.InstanceSet``): the
        mesh's Woop and material tensors are stored ONCE; each transform
        adds only ~72 bytes per prototype cluster of expanded traversal
        metadata.

        ``transforms``: sequence of (3, 4) or (4, 4) affine matrices (any
        invertible affine; normals transform exactly by the inverse
        transpose). Enforced at ``build()``: instanced materials cannot be
        emissive (the light table indexes world-space triangles) and the
        expanded cluster count must fit the flat kernels' budget.

        ``materials`` (optional): one material id (or None) PER TRANSFORM,
        overriding ``mat_id`` for that instance. Overrides cannot be
        emissive either.

        ``motion_transforms`` (optional): one SHUTTER-CLOSE transform (or
        None = static) per entry of ``transforms`` — object motion blur.
        The forward affine is lerped per ray at the path's shutter time
        (``ops.cluster_trace._lerp_affine_inverse``)."""
        vertices = np.asarray(vertices, np.float64)
        faces = np.asarray(faces, np.int64)
        tri = vertices[faces]
        v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
        mats = np.full(tri.shape[0], int(mat_id), np.int32)

        def affine(m, what):
            m = np.asarray(m, np.float64)
            if m.shape == (4, 4):
                m = m[:3]
            if m.shape != (3, 4):
                raise ValueError(
                    f"{what} transform must be (3,4) or (4,4); "
                    f"got {m.shape}"
                )
            if abs(np.linalg.det(m[:, :3])) < 1e-12:
                raise ValueError(f"{what} transform is singular")
            return m

        ts = [affine(m, "instance") for m in transforms]
        if not ts:
            raise ValueError("add_instances needs at least one transform")
        if motion_transforms is None:
            mts = [None] * len(ts)
        else:
            if len(motion_transforms) != len(ts):
                raise ValueError(
                    "add_instances motion_transforms must match "
                    f"transforms ({len(motion_transforms)} vs {len(ts)})"
                )
            mts = [None if m1 is None else affine(m1, "motion")
                   for m1 in motion_transforms]
        if materials is None:
            imats = [-1] * len(ts)
        else:
            if len(materials) != len(ts):
                raise ValueError(
                    "add_instances materials must match transforms "
                    f"({len(materials)} vs {len(ts)})"
                )
            imats = [int(m) if m is not None else -1 for m in materials]
        # Cast, then subtract in f32, as build() forms its edges: an
        # identity-transform instance must trace bit-identically to the
        # same mesh added flat.
        v0f = v0.astype(np.float32)
        self._protos.append((
            v0f, v1.astype(np.float32) - v0f,
            v2.astype(np.float32) - v0f, mats, ts, imats, mts,
        ))

    # -- finalize ----------------------------------------------------------
    def build(self, device=None, page_clusters: int = 0) -> Scene:
        """Build the scene's tables on the host and upload them to
        ``device`` (the card unless the caller asks for another device).
        The scene is paged (``ops.clusters.build_pages``) under the JAX
        package's condition: past ``DNF_MAX_CLUSTERS`` clusters, past
        ``CAND_MAX_NODES`` tree nodes, or whenever ``page_clusters`` (a
        forced page size, for tests) is given."""
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
        over_budget = cl.woop.shape[0] > cluster_trace.DNF_MAX_CLUSTERS
        if self._protos and (page_clusters or over_budget):
            raise ValueError(
                "instanced scenes cannot page: base geometry must fit "
                f"the flat DNF budget ({cluster_trace.DNF_MAX_CLUSTERS} "
                "clusters)"
            )
        pages = None
        if page_clusters or over_budget or (
                cl.node_meta.shape[1] > cluster_ops.CAND_MAX_NODES):
            cl, pages, _ = cluster_ops.build_pages(
                cl, page_clusters or cluster_ops.PAGE_CLUSTERS
            )
        v0, e1, e2, tri_mat = v0[perm], e1[perm], e2[perm], tri_mat[perm]

        mat_type = np.array([m[0] for m in self._mat], np.int32)
        instances = None
        if self._protos:
            cl, instances = self._expand_protos(cl, mat_type)

        mat_albedo = np.array([m[1] for m in self._mat], np.float32)
        mat_param = np.array([m[2] for m in self._mat], np.float32)
        mat_emit = np.array([m[3] for m in self._mat], np.float32)

        def dev(x, dtype=torch.float32):
            return torch.as_tensor(x, dtype=dtype, device=device)

        mat_metallic = mat_clearcoat = None
        if (mat_type == materials.TYPE_PRINCIPLED).any():
            mat_metallic = dev(np.array(self._mat_metallic, np.float32))
            cc = np.array(self._mat_cc, np.float32)
            if (cc[:, 0] > 0.0).any():
                mat_clearcoat = dev(cc)
        # Each optional column exists only when some material uses it, as
        # the JAX SceneBuilder decides: other scenes never build its lobe.
        absorb = np.array(self._mat_absorb, np.float32)
        disp = np.array(self._mat_disp, np.float32)
        aniso = np.array(self._mat_aniso, np.float32)
        mat_absorb = dev(absorb) if (absorb > 0.0).any() else None
        mat_param2 = (dev(np.array(self._mat_param2, np.float32))
                      if (mat_type == materials.TYPE_ROUGH_DIELECTRIC).any()
                      else None)
        mat_disp = dev(disp) if (disp > 0.0).any() else None
        mat_aniso = dev(aniso) if (aniso > 0.0).any() else None
        env = self._env
        if isinstance(env, envmap.EnvMap):
            env = envmap.EnvMap(*(x.to(device) for x in env))
        elif env is not None:
            env = envmap.build_envmap(env, device)

        def dev_all(table):
            return type(table)(*(
                None if x is None else dev(
                    x, torch.float32 if x.dtype == np.float32
                    else torch.int32)
                for x in table))

        if instances is not None:
            instances = dev_all(instances)

        return Scene(
            env=env, delta=lights.build_delta_lights(self._delta, device),
            mat_absorb=mat_absorb, mat_param2=mat_param2, mat_disp=mat_disp,
            mat_aniso=mat_aniso,
            mat_metallic=mat_metallic, mat_clearcoat=mat_clearcoat,
            instances=instances,
            pages=None if pages is None else dev_all(pages),
            sph_center=dev(sph_center), sph_radius=dev(sph_radius),
            sph_mat=dev(sph_mat, torch.int32),
            tri_v0=dev(v0), tri_e1=dev(e1), tri_e2=dev(e2),
            tri_mat=dev(tri_mat, torch.int32),
            mat_type=dev(mat_type, torch.int32), mat_albedo=dev(mat_albedo),
            mat_param=dev(mat_param), mat_emit=dev(mat_emit),
            clusters=dev_all(cl),
            lights=lights.build_light_table(
                v0, v0 + e1, v0 + e2, tri_mat, mat_type, mat_emit,
                materials.TYPE_EMISSIVE, device,
                sph_center=sph_center, sph_radius=sph_radius,
                sph_mat=sph_mat,
            ),
        )

    def _expand_protos(self, cl, mat_type):
        """Append each prototype's clusters (built in OBJECT space, packed
        per prototype so cluster ranges stay contiguous) after the base
        clusters, then expand the placements — base geometry as one
        identity entry, every instance as a (first, count, M, imat, M1)
        range — into the InstanceSet. The combined ClusterSet keeps the
        base geometry's tree fields (instanced scenes never walk a tree).
        Returns (combined ClusterSet, InstanceSet), numpy."""
        n_base = cl.aabb_min.shape[0]
        placements = [(0, n_base, np.concatenate(
            [np.eye(3), np.zeros((3, 1))], axis=1))]
        parts = [cl]
        offset = n_base
        for pv0, pe1, pe2, pmats, ts, imats, mts in self._protos:
            if (mat_type[pmats] == materials.TYPE_EMISSIVE).any():
                raise ValueError(
                    "instanced prototypes cannot use emissive materials "
                    "(the NEE light table indexes world-space triangles); "
                    "add emitters as base geometry"
                )
            for im in imats:
                if im >= 0 and mat_type[im] == materials.TYPE_EMISSIVE:
                    raise ValueError(
                        "per-instance material overrides cannot be "
                        "emissive (same light-table reason)"
                    )
            pcl, _, _ = cluster_ops.build_clusters(pv0, pe1, pe2, pmats)
            npc = pcl.aabb_min.shape[0]
            parts.append(pcl)
            for m, im, m1 in zip(ts, imats, mts):
                placements.append((offset, npc, m, im, m1))
            offset += npc
        cl = cl._replace(**{
            f: np.concatenate([getattr(p, f) for p in parts])
            for f in ("aabb_min", "aabb_max", "woop", "normal", "mat")})
        instances = cluster_ops.expand_instances(cl, placements)
        ce = instances.cmap.shape[0]
        if ce > cluster_trace.DNF_MAX_CLUSTERS:
            raise ValueError(
                f"{ce} expanded instance clusters exceed the DNF budget "
                f"({cluster_trace.DNF_MAX_CLUSTERS}); reduce instance "
                "counts or split the scene"
            )
        return cl, instances


def has_motion(scene: Scene) -> bool:
    """True when the scene carries motion-blurred instances: the engine
    then draws a per-path shutter time and passes it to every closest-hit
    and shadow query."""
    return scene.instances is not None and scene.instances.fw0 is not None


def uses_mips(scene: Scene) -> bool:
    """Texture mip pyramids are not ported yet: always False."""
    return False


def uses_dnf(scene: Scene) -> bool:
    """True when cluster queries route to a cluster sweep (flat, instanced
    or paged): the megakernel then compacts its waves, as in the JAX
    package. False only for an unpaged scene past ``DNF_MAX_CLUSTERS``,
    which walks the cluster tree. (The JAX package also sorts that route's
    rays into octant bins, ``binning.ray_bin``; the result does not depend
    on the order, and the port's walk takes each ray's own octant, so the
    port does not bin: ROADMAP queue A item 13.)"""
    return scene.clusters is not None and (
        scene.pages is not None
        or scene.instances is not None
        or scene.clusters.woop.shape[0] <= cluster_trace.DNF_MAX_CLUSTERS
    )


def _sphere_pass(scene: Scene, origin, direction):
    """(R, S) ray–sphere distances for a ray batch (brute force over the
    small sphere set)."""
    return intersect.ray_sphere(
        origin[:, None, :], direction[:, None, :],
        scene.sph_center[None, :, :], scene.sph_radius[None, :],
    )


_ROUTES = {
    # (query, route): (plain version, dispatching kernel wrapper)
    # The flat pair walks the set's cluster tree in both versions;
    # trace_torch and occluded_torch (the JAX order) are the oracles the
    # tests hold them to.
    ("trace", "flat"): (cluster_trace.trace_flat_walk_torch,
                        cluster_trace.trace),
    ("occluded", "flat"): (cluster_trace.occluded_tree_torch,
                           cluster_trace.occluded),
    ("trace", "instanced"): (cluster_trace.trace_inst_torch,
                             cluster_trace.trace_inst),
    ("occluded", "instanced"): (cluster_trace.occluded_inst_torch,
                                cluster_trace.occluded_inst),
    ("trace", "paged"): (cluster_trace.trace_paged_walk_torch,
                         cluster_trace.trace_paged_dnf),
    # The JAX package answers paged occlusion with its closest-hit page
    # sweep (the TPU's tile sweep gains nothing from stopping a lane early);
    # the port's paged walk retires a lane at its first occluder.
    ("occluded", "paged"): (cluster_trace.occluded_paged_dnf_torch,
                            cluster_trace.occluded_paged_dnf),
    ("trace", "tree"): (cluster_trace.trace_tree_torch,
                        cluster_trace.trace_tree),
    ("occluded", "tree"): (cluster_trace.occluded_tree_torch,
                           cluster_trace.occluded_tree),
}


def cluster_route(scene: Scene) -> str:
    """Which traversal a scene's cluster queries take, as in the JAX
    package: "instanced", "paged", "flat" (at most ``DNF_MAX_CLUSTERS``
    clusters) or "tree" (an unpaged scene past that budget)."""
    if scene.instances is not None:
        return "instanced"
    if scene.pages is not None:
        return "paged"
    if scene.clusters.woop.shape[0] <= cluster_trace.DNF_MAX_CLUSTERS:
        return "flat"
    return "tree"


def _cluster_query(scene: Scene, query: str, traversal: str):
    """The cluster traversal of this scene under ``traversal``, as a
    function (origin, direction, cap, time) -> result. Instanced scenes
    take the instanced pair (``time`` is the per-ray shutter time of a
    motion set); the other routes ignore ``time``."""
    route = cluster_route(scene)
    if route == "instanced" and traversal == "bvh":
        raise ValueError(
            "instanced scenes need a cluster traversal mode (the BVH only "
            "indexes base triangles)"
        )
    if traversal not in ("cluster_torch", "cluster_cuda"):
        raise ValueError(f"unknown traversal mode: {traversal!r}")
    fn = _ROUTES[query, route][traversal == "cluster_cuda"]
    if route == "instanced":
        return lambda o, d, cap, time: fn(scene.clusters, scene.instances,
                                          o, d, cap, time=time)
    if route == "paged":
        return lambda o, d, cap, time: fn(scene.clusters, scene.pages,
                                          o, d, cap)
    return lambda o, d, cap, time: fn(scene.clusters, o, d, cap)


def occluded_batch(scene: Scene, origin, direction, t_max,
                   traversal: str, active=None, time=None):
    """Any-hit occlusion for a (R, 3) ray batch: True where any primitive
    lies strictly inside (T_MIN, t_max). Lanes the sphere pass already
    occluded, and inactive lanes, get a zero cap so the cluster sweep
    skips them (the result ORs the sphere answer back in). ``time``
    (optional (R,)): per-ray shutter time for motion-blurred instances."""
    query = _cluster_query(scene, "occluded", traversal)
    ts = _sphere_pass(scene, origin, direction)
    occ_sph = torch.min(ts, dim=1).values < t_max
    if active is not None:
        occ_sph = occ_sph & active
    cap = t_max
    if active is not None:
        cap = torch.where(active, cap, 0.0)
    cap = torch.where(occ_sph, 0.0, cap)
    return occ_sph | query(origin, direction, cap, time)


def intersect_batch(scene: Scene, origin, direction, traversal: str,
                    active=None, t_max=None, time=None) -> Hit:
    """Closest hit for a whole (R, 3) ray batch. Spheres first (their best
    t culls the cluster sweep); ``active`` (optional (R,) bool) gives dead
    lanes ``t_init = 0``, and their Hit fields are garbage the callers
    mask. ``time`` (optional (R,)): per-ray shutter time for
    motion-blurred instances."""
    query = _cluster_query(scene, "trace", traversal)
    ts = _sphere_pass(scene, origin, direction)               # (R, S)
    sph_t, sph_idx = torch.min(ts, dim=1)
    t_init = torch.where(torch.isfinite(sph_t), sph_t, 3.0e38)
    if t_max is not None:
        t_init = torch.minimum(t_init, t_max)
    if active is not None:
        t_init = torch.where(active, t_init, 0.0)

    tri_t, slot, n_tri, mat_tri = query(origin, direction, t_init, time)

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
