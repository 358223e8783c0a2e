"""Scene representation (the JAX package's ``models/scene.py``): spheres,
triangles, the threaded BVH, cluster tables, shared-geometry instances,
the material table with its optional columns, surface attributes (per-
corner uvs and shading normals, the slot-indexed ``attr_pack``), the
texture atlas, the area-light table, delta lights, the environment map
and the participating media (homogeneous fog, a voxel-grid volume, the
interior scattering of dielectrics), as tensors on one device.

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
to the cluster-tree walk; and, the port's own, a scene with ``inst_tree``
(static placements past that budget) to the two-level instanced walk. ``traversal="bvh"`` walks the threaded BVH
instead (``ops.bvh.traverse``, plain torch), as the JAX package's CPU
default does; it refuses instanced scenes. With ``bin_rays`` both cluster
routes sort a query's rays into (coarse cell, direction octant) bins
first and restore their order after it (``ops.binning``), as the JAX
package does. ``scene_from_numpy`` takes the JAX package's Scene fields
as numpy arrays, so one scene can feed both packages.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from pathtracing_tpu_torch.models.meshes import smooth_vertex_normals
from pathtracing_tpu_torch.ops import binning
from pathtracing_tpu_torch.ops import bvh as bvh_ops
from pathtracing_tpu_torch.ops import clusters as cluster_ops
from pathtracing_tpu_torch.ops import cluster_trace, envmap, intersect
from pathtracing_tpu_torch.ops import lights, linalg
from pathtracing_tpu_torch.ops import materials
from pathtracing_tpu_torch.ops import texture as texture_ops
from pathtracing_tpu_torch.ops import volume as volume_ops
from pathtracing_tpu_torch.utils import metrics
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
    # Two-level instancing (ops.clusters.InstanceTree) of a scene whose
    # expanded placements would pass ``DNF_MAX_CLUSTERS``: a tree over the
    # placements (the base geometry as an identity placement) above the
    # prototypes' trees over the clusters stored in ``clusters``. When set,
    # every cluster query takes the two-level walks; never together with
    # ``instances``.
    inst_tree: cluster_ops.InstanceTree = None
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
    # The threaded BVH over the stored triangles (ops.bvh.FlatBVH), walked
    # by traversal="bvh". None for a scene made without one.
    bvh: bvh_ops.FlatBVH = None
    # Surface attributes, None unless the builder saw any (attribute-free
    # scenes gather nothing): per-corner uvs (T, 3, 2) and shading normals
    # (T, 3, 3) in stored triangle order (a zero shading-normal row means
    # "use the geometric normal"); slot_to_tri (C*128,) i32 maps a padded
    # cluster slot to its stored triangle row (-1: padding, or an
    # instanced prototype's slot); attr_pack (C*128, 25) f32 holds, per
    # slot, [valid, v0, e1, e2, shn (9), uv (6)] with the row arrays' own
    # bits, so a cluster hit resolves its attributes by ONE gather.
    attr_uv: torch.Tensor = None
    attr_shn: torch.Tensor = None
    slot_to_tri: torch.Tensor = None
    attr_pack: torch.Tensor = None
    # Image textures (ops.texture.TextureAtlas) and the per-material atlas
    # ids (K,) i32 (-1: none) of the albedo texture, the tangent-space
    # normal map and the metallic-roughness map; each column None unless
    # some material uses it, the atlas None unless one does.
    textures: texture_ops.TextureAtlas = None
    mat_tex: torch.Tensor = None
    mat_ntex: torch.Tensor = None
    mat_mrtex: torch.Tensor = None
    # (K, 2) f32 interior scattering [sigma_s, g] of dielectrics: a path
    # inside random-walks with Exp(sigma_s) flights and Henyey–Greenstein
    # phase scattering. None unless some material scatters (the engines
    # then carry a per-path ``sss`` row).
    mat_interior: torch.Tensor = None
    # (3,) f32 homogeneous fog [sigma_s, sigma_a, g]; None for fog-free
    # scenes, which never draw STREAM_FOG.
    fog: torch.Tensor = None
    # Voxel-grid medium (ops.volume.VolumeGrid); None for grid-free scenes,
    # which never fold STREAM_VOL or STREAM_VOLT. Never together with fog.
    vol: volume_ops.VolumeGrid = None

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
    # int32 stored triangle row of a triangle hit (-1 for spheres and
    # misses, and on the cluster routes of a scene without slot_to_tri):
    # the attribute row of the "bvh" route.
    prim: torch.Tensor
    # int32 padded cluster slot (-1 for spheres/misses); None on the "bvh"
    # route. With attr_pack it resolves the attributes.
    slot: torch.Tensor = None


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
    ``clusters``, ``lights``, ``instances``, ``pages``, ``bvh`` and
    ``textures`` may be dicts or NamedTuples; ``vol`` a VolumeGrid of
    numpy arrays or a dict of its fields). The TPU lookahead kernel's
    ``cand_box`` blocks are dropped. A cluster set without a tree gets one
    (``clusters.with_tree``)."""
    arrays = _fields(arrays)
    device = torch.device(device)

    def dev(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    def opt(table, name, dtype):
        x = table.get(name)
        return None if x is None else dev(x, dtype)

    cl = _fields(arrays["clusters"])
    li = _fields(arrays["lights"])
    # The flat kernels walk the set's cluster tree: a set that comes
    # without one gets one, built over its real clusters.
    host_cl = cluster_ops.with_tree(cluster_ops.ClusterSet(**{
        f: None if cl.get(f) is None else np.asarray(cl[f])
        for f in cluster_ops.ClusterSet._fields}))
    fields = {n: dev(arrays[n], torch.float32) for n in _FLOAT_FIELDS}
    fields.update({n: dev(arrays[n], torch.int32) for n in _INT_FIELDS})
    for n in ("attr_uv", "attr_shn", "attr_pack"):
        fields[n] = opt(arrays, n, torch.float32)
    for n in ("slot_to_tri", "mat_tex", "mat_ntex", "mat_mrtex"):
        fields[n] = opt(arrays, n, torch.int32)
    if arrays.get("bvh") is not None:
        bv = _fields(arrays["bvh"])
        fields["bvh"] = bvh_ops.FlatBVH(
            node_min=dev(bv["node_min"], torch.float32),
            node_max=dev(bv["node_max"], torch.float32),
            node_meta=dev(bv["node_meta"], torch.int32))
    if arrays.get("textures") is not None:
        fields["textures"] = texture_ops.to_device(
            texture_ops.TextureAtlas(**_fields(arrays["textures"])), device)
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
    light_cols = {n: opt(li, n, torch.int32 if n in ("kind", "tex")
                         else torch.float32)
                  for n in lights.LightTable._fields}
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
        mat_interior=opt(arrays, "mat_interior", torch.float32),
        fog=opt(arrays, "fog", torch.float32),
        vol=(None if arrays.get("vol") is None
             else volume_ops.to_device(arrays["vol"], device)),
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
        lights=lights.LightTable(**light_cols),
        **fields,
    )


class SceneBuilder:
    """Host-side scene assembly (numpy), as the JAX package's
    ``SceneBuilder``; ``build`` uploads the tensors to one device."""

    def __init__(self) -> None:
        self._sph = []         # (center, radius, mat)
        self._tri = []         # (v0, v1, v2, mat, uv3 | None)
        # (v0 (k,3), v1, v2, mat (k,), uv3 (k,3,2) | None,
        #  shn3 (k,3,3) | None) arrays
        self._tri_chunks = []
        self._mat = []         # (type, albedo, param, emit)
        self._mat_metallic = []  # per-material metallic (principled)
        self._mat_cc = []      # per-material (clearcoat, coat roughness)
        self._mat_absorb = []  # per-material interior sigma_a (r, g, b)
        self._mat_sss = []     # per-material interior (sigma_s, g)
        self._mat_param2 = []  # per-material second scalar (rough alpha)
        self._mat_disp = []    # per-material IOR dispersion (blue - red)
        self._mat_aniso = []   # per-material GGX anisotropy [0, 1)
        self._mat_tex = []     # per-material texture id (-1 = none)
        self._mat_ntex = []    # per-material normal-map id (-1 = none)
        self._mat_mrtex = []   # per-material metallic-roughness map id
        self._tex = []         # host texture images (H, W, 3) f32
        self._mipmaps = False  # build a mip pyramid into the atlas
        # (v0, e1, e2, mats, [(3,4) transforms], [imat], [motion (3,4)])
        self._protos = []
        self._delta = []       # delta-light spec dicts (ops.lights)
        self._env = None       # (H, W, 3) texels or an ops.envmap.EnvMap
        self._fog = None       # (sigma_s, sigma_a, g) scattering fog
        self._vol = None       # ops.volume.VolumeGrid on the CPU

    # -- media -------------------------------------------------------------
    def set_fog(self, sigma_s: float, sigma_a: float = 0.0,
                g: float = 0.0) -> None:
        """Fill the scene with a homogeneous scattering medium: shading
        distance-samples it, scatters by the Henyey–Greenstein phase of
        anisotropy ``g`` and combines phase sampling with NEE by MIS.
        ``sigma_s + sigma_a`` must be > 0."""
        if sigma_s + sigma_a <= 0.0:
            raise ValueError("fog needs sigma_s + sigma_a > 0")
        if not -1.0 < g < 1.0:
            raise ValueError("HG anisotropy g must be in (-1, 1)")
        self._fog = (float(sigma_s), float(sigma_a), float(g))
        if self._vol is not None:
            raise ValueError("fog and a volume grid are mutually "
                             "exclusive (untested combined estimator)")

    def set_volume(self, density, bbox_min, bbox_max, sigma_s: float,
                   sigma_a: float = 0.0, g: float = 0.0, n_steps=None,
                   emission=None, emit_color=None) -> None:
        """Place a voxel-grid medium (``ops.volume``): ``density`` is a
        (Nz, Ny, Nx) non-negative array filling the box [bbox_min,
        bbox_max]; extinction is ``trilinear(density) * (sigma_s +
        sigma_a)``, scattering the Henyey–Greenstein phase of anisotropy
        ``g``. An ``emission`` grid (same shape) times ``emit_color``
        makes the medium emit; emissive media need ``sigma_a > 0``."""
        if self._fog is not None:
            raise ValueError("fog and a volume grid are mutually "
                             "exclusive (untested combined estimator)")
        if not -1.0 < g < 1.0:
            raise ValueError("HG anisotropy g must be in (-1, 1)")
        self._vol = volume_ops.build_grid(
            density, bbox_min, bbox_max, sigma_s, sigma_a=sigma_a, g=g,
            n_steps=n_steps, emission=emission, emit_color=emit_color)

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

    # -- textures ----------------------------------------------------------
    def set_mipmaps(self, enabled: bool = True) -> None:
        """Build a box-filtered mip pyramid into the texture atlas and
        render with ray-cone LOD selection (``ops.texture``). Off by
        default: the mip-free atlas keeps its layout and the engine its
        state."""
        self._mipmaps = bool(enabled)

    def add_texture(self, image, srgb: bool = True) -> int:
        """Register a texture: an (H, W, 3) linear float image, or a path
        (PNG/JPEG converted from sRGB unless ``srgb=False``, as for normal
        maps; .hdr and .npy load as they are). Returns the texture id to
        pass as a material's ``texture=`` (or ``normal_map=``,
        ``mr_texture=``)."""
        if isinstance(image, (str, os.PathLike)):
            image = texture_ops.load_texture(os.fspath(image), srgb=srgb)
        self._tex.append(np.asarray(image, np.float32))
        return len(self._tex) - 1

    def _tex_id(self, texture, srgb: bool = True) -> int:
        if texture is None:
            return -1
        if isinstance(texture, int):
            if not 0 <= texture < len(self._tex):
                raise ValueError(f"unknown texture id {texture}")
            return texture
        return self.add_texture(texture, srgb=srgb)

    # -- materials ---------------------------------------------------------
    def add_material(self, mtype, albedo=(0.0, 0.0, 0.0), param=0.0,
                     emit=(0.0, 0.0, 0.0), texture=None,
                     absorption=(0.0, 0.0, 0.0), param2=0.0,
                     normal_map=None, dispersion=0.0, metallic=0.0,
                     mr_texture=None, clearcoat=0.0,
                     clearcoat_roughness=0.1, anisotropy=0.0,
                     scattering=0.0, scatter_g=0.0) -> int:
        """``texture``: a texture id, or an image array, whose texel
        MODULATES the albedo (the emission of an emitter) at uv-mapped hits;
        ``normal_map``: a tangent-space normal map (texels decode as
        2·rgb − 1 = (t, b, n)); ``mr_texture``: a metallic-roughness map
        (G scales the roughness, B the metallic).
        ``absorption``: interior Beer–Lambert sigma_a per channel (on
        dielectrics: paths inside lose exp(−sigma_a · distance));
        ``param2``: the rough dielectric's GGX alpha; ``dispersion``: the
        IOR spread of a smooth dielectric; ``anisotropy`` in [0, 1): the
        GGX conductor's; ``scattering``: the interior scattering
        coefficient sigma_s of a dielectric, with HG anisotropy
        ``scatter_g`` (``Scene.mat_interior``)."""
        if not 0.0 <= anisotropy < 1.0:
            raise ValueError("anisotropy must be in [0, 1)")
        if scattering < 0.0:
            raise ValueError("scattering (sigma_s) must be >= 0")
        if not -1.0 < scatter_g < 1.0:
            raise ValueError("HG anisotropy scatter_g must be in (-1, 1)")
        self._mat.append((int(mtype), tuple(albedo), float(param),
                          tuple(emit)))
        self._mat_absorb.append(tuple(float(x) for x in absorption))
        self._mat_sss.append((float(scattering), float(scatter_g)))
        self._mat_param2.append(float(param2))
        self._mat_disp.append(float(dispersion))
        self._mat_metallic.append(float(metallic))
        self._mat_cc.append((float(clearcoat), float(clearcoat_roughness)))
        self._mat_aniso.append(float(anisotropy))
        self._mat_tex.append(self._tex_id(texture))
        self._mat_ntex.append(self._tex_id(normal_map, srgb=False))
        self._mat_mrtex.append(self._tex_id(mr_texture, srgb=False))
        return len(self._mat) - 1

    def lambertian(self, albedo, texture=None, normal_map=None) -> int:
        return self.add_material(materials.TYPE_LAMBERTIAN, albedo,
                                 texture=texture, normal_map=normal_map)

    def metal(self, albedo, fuzz=0.0, texture=None, normal_map=None) -> int:
        return self.add_material(materials.TYPE_METAL, albedo, fuzz,
                                 texture=texture, normal_map=normal_map)

    def ggx(self, f0, roughness=0.1, texture=None, normal_map=None,
            anisotropy=0.0) -> int:
        """Microfacet conductor: f0 = Fresnel normal reflectance,
        roughness = GGX alpha. Unlike ``metal`` it has a real pdf, so
        glossy vertices take part in NEE/MIS. ``anisotropy`` in [0, 1)
        stretches the NDF along the surface tangent (Disney aspect
        convention): brushed-metal highlights."""
        return self.add_material(materials.TYPE_GGX, f0, roughness,
                                 texture=texture, normal_map=normal_map,
                                 anisotropy=anisotropy)

    def principled(self, base_color, metallic=0.0, roughness=0.5,
                   texture=None, normal_map=None, mr_texture=None,
                   clearcoat=0.0, clearcoat_roughness=0.1) -> int:
        """Metallic-roughness material: diffuse + GGX specular with
        F0 = lerp(0.04, base_color, metallic); ``roughness`` is perceptual
        (GGX alpha = roughness²). Fully NEE/MIS-eligible. ``clearcoat``
        adds a second GGX layer at fixed IOR 1.5 with its own
        ``clearcoat_roughness``; the layer's Fresnel attenuates the base
        lobes. ``texture`` modulates the base color; ``mr_texture`` is a
        metallic-roughness map (G scales ``roughness``, B ``metallic``)."""
        return self.add_material(
            materials.TYPE_PRINCIPLED, base_color, roughness,
            texture=texture, normal_map=normal_map, mr_texture=mr_texture,
            metallic=metallic, clearcoat=clearcoat,
            clearcoat_roughness=clearcoat_roughness,
        )

    def dielectric(self, ior=1.5, tint=(1.0, 1.0, 1.0),
                   absorption=(0.0, 0.0, 0.0), roughness=0.0,
                   dispersion=0.0, scattering=0.0,
                   scatter_g=0.0) -> int:
        """``absorption``: interior sigma_a (Beer–Lambert), e.g.
        (0.1, 2.0, 2.0) is red glass. ``roughness`` > 0 selects the
        microfacet (Walter 2007) glass with GGX alpha = roughness.
        ``dispersion``: IOR spread blue − red, smooth dielectrics only;
        a path splits to one RGB channel at its first dispersive hit.
        ``scattering``: interior sigma_s; paths inside random-walk with
        Exp(sigma_s) flights and HG anisotropy ``scatter_g`` (volumetric
        subsurface scattering; a chromatic ``absorption`` colors it).
        Dispersion and scattering are mutually exclusive."""
        if scattering > 0.0 and dispersion > 0.0:
            raise ValueError("dispersion + scattering unsupported")
        if roughness > 0.0:
            return self.add_material(
                materials.TYPE_ROUGH_DIELECTRIC, tint, ior,
                absorption=absorption, param2=roughness,
                scattering=scattering, scatter_g=scatter_g,
            )
        return self.add_material(
            materials.TYPE_DIELECTRIC, tint, ior, absorption=absorption,
            dispersion=dispersion, scattering=scattering,
            scatter_g=scatter_g,
        )

    def emissive(self, radiance, texture=None) -> int:
        """``texture`` modulates the emitted radiance by the texel at the
        hit or sampled uv (the emitter needs uvs); light selection and the
        MIS pdfs stay on the base ``radiance``."""
        return self.add_material(materials.TYPE_EMISSIVE, (0.0, 0.0, 0.0),
                                 0.0, radiance, texture=texture)

    def checker(self, color1, color2, frequency: float = 3.0) -> int:
        """Procedural two-tone Lambertian (world-space checkerboard); the
        emit columns carry the second color, param the frequency."""
        return self.add_material(materials.TYPE_CHECKER, color1, frequency,
                                 color2)

    # -- geometry ----------------------------------------------------------
    def add_sphere(self, center, radius, mat_id) -> None:
        self._sph.append((tuple(center), float(radius), int(mat_id)))

    def add_triangle(self, v0, v1, v2, mat_id, uv=None) -> None:
        """``uv`` (optional): three (u, v) pairs, one per corner."""
        uv3 = None if uv is None else tuple(
            (float(p[0]), float(p[1])) for p in uv)
        self._tri.append((tuple(v0), tuple(v1), tuple(v2), int(mat_id),
                          uv3))

    def add_quad(self, corner, edge_u, edge_v, mat_id, uv=False) -> None:
        """Parallelogram as two triangles (Cornell walls). ``uv=True``
        attaches the unit square's coordinates (corner (0, 0), corner +
        edge_u (1, 0), corner + edge_v (0, 1))."""
        c = np.asarray(corner, np.float64)
        u = np.asarray(edge_u, np.float64)
        v = np.asarray(edge_v, np.float64)
        uv_a = ((0, 0), (1, 0), (1, 1)) if uv else None
        uv_b = ((0, 0), (1, 1), (0, 1)) if uv else None
        self.add_triangle(c, c + u, c + u + v, mat_id, uv=uv_a)
        self.add_triangle(c, c + u + v, c + v, mat_id, uv=uv_b)

    def add_mesh(self, vertices: np.ndarray, faces: np.ndarray, mat_id,
                 uvs=None, uv_faces=None, normals=None, normal_faces=None,
                 smooth: bool = False) -> None:
        """Indexed triangle mesh: vertices (V,3) float, faces (F,3) int,
        stored as one array chunk. Optional surface attributes: ``uvs``
        (U, 2) with ``uv_faces`` (F, 3) (default ``faces``); shading
        ``normals`` (M, 3) with ``normal_faces`` (F, 3) (default
        ``faces``); ``smooth=True`` derives area-weighted vertex normals
        (``models.meshes.smooth_vertex_normals``) when none are given."""
        vertices = np.asarray(vertices, np.float64)
        faces = np.asarray(faces, np.int64)
        tri = vertices[faces]  # (F, 3, 3)
        uv3 = None
        if uvs is not None:
            uvf = faces if uv_faces is None else np.asarray(uv_faces,
                                                            np.int64)
            uv3 = np.asarray(uvs, np.float64)[uvf].astype(np.float32)
        shn3 = None
        if normals is None and smooth:
            normals = smooth_vertex_normals(vertices, faces)
            normal_faces = faces
        if normals is not None:
            nf = faces if normal_faces is None else np.asarray(
                normal_faces, np.int64)
            shn3 = np.asarray(normals, np.float64)[nf].astype(np.float32)
        self._tri_chunks.append((
            tri[:, 0], tri[:, 1], tri[:, 2],
            np.full(tri.shape[0], int(mat_id), np.int32), uv3, shn3,
        ))

    def add_instances(self, vertices: np.ndarray, faces: np.ndarray,
                      mat_id, transforms, materials=None,
                      motion_transforms=None) -> None:
        """Instance one prototype mesh many times by object→world affine
        transforms — shared geometry (``ops.clusters.InstanceSet``): the
        mesh's Woop and material tensors are stored ONCE; each transform
        adds ~72 bytes per prototype cluster of expanded traversal
        metadata, or past the flat budget one record of its own.

        ``transforms``: sequence of (3, 4) or (4, 4) affine matrices (any
        invertible affine; normals transform exactly by the inverse
        transpose). Enforced at ``build()``: instanced materials cannot be
        emissive (the light table indexes world-space triangles), and
        moving instances must fit the flat kernels' budget once expanded
        (static ones past it take the two-level walk).

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
            uv3 = None
            if any(x[4] is not None for x in t):
                uv3 = np.zeros((len(t), 3, 2), np.float32)
                for i, x in enumerate(t):
                    if x[4] is not None:
                        uv3[i] = x[4]
            chunks.append((
                np.array([x[0] for x in t], np.float64),
                np.array([x[1] for x in t], np.float64),
                np.array([x[2] for x in t], np.float64),
                np.array([x[3] for x in t], np.int32),
                uv3, None,
            ))
        if not chunks:
            z = np.zeros((1, 3), np.float64)
            chunks = [(z, z, z, np.zeros(1, np.int32), None, None)]
        v0 = np.concatenate([c[0] for c in chunks]).astype(np.float32)
        v1 = np.concatenate([c[1] for c in chunks]).astype(np.float32)
        v2 = np.concatenate([c[2] for c in chunks]).astype(np.float32)
        tri_mat = np.concatenate([c[3] for c in chunks]).astype(np.int32)
        e1 = v1 - v0
        e2 = v2 - v0

        def gather_attr(col: int, width: int):
            """Column ``col`` of the chunks (uvs, shading normals) over
            all triangles, zeros for chunks without it; None when no
            chunk has it."""
            if not any(c[col] is not None for c in chunks):
                return None
            return np.concatenate([
                c[col].astype(np.float32) if c[col] is not None
                else np.zeros((c[0].shape[0], 3, width), np.float32)
                for c in chunks])

        attr_uv = gather_attr(4, 2)
        attr_shn = gather_attr(5, 3)
        has_attrs = attr_uv is not None or attr_shn is not None

        # The leaf-size-4 BVH fixes the stored triangle order (which the
        # light table, and so the light picks, follow) and is the "bvh"
        # route's tree.
        (node_min, node_max, node_meta), perm = bvh_ops.build_bvh(v0, e1,
                                                                  e2)
        cl, _, slot_to_tri = cluster_ops.build_clusters(v0, e1, e2, tri_mat)
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
            cl, pages, page_remap = cluster_ops.build_pages(
                cl, page_clusters or cluster_ops.PAGE_CLUSTERS
            )
            slot_to_tri = cluster_ops.remap_slot_to_tri(
                slot_to_tri, page_remap, cl.aabb_min.shape[0])
        v0, e1, e2, tri_mat = v0[perm], e1[perm], e2[perm], tri_mat[perm]
        if has_attrs:
            # Attribute rows follow the stored (BVH) order; the slots'
            # input indices are retargeted to stored rows.
            if attr_uv is not None:
                attr_uv = attr_uv[perm]
            if attr_shn is not None:
                attr_shn = attr_shn[perm]
            inv_perm = np.empty(perm.shape[0], np.int64)
            inv_perm[perm] = np.arange(perm.shape[0])
            slot_to_tri = np.where(
                slot_to_tri >= 0, inv_perm[np.maximum(slot_to_tri, 0)], -1,
            ).astype(np.int32)

        mat_type = np.array([m[0] for m in self._mat], np.int32)
        instances = inst_tree = None
        if self._protos:
            n_base = cl.aabb_min.shape[0]
            cl, instances, inst_tree = self._place_protos(cl, mat_type)
            if has_attrs:
                # Prototype slots carry no attribute rows: instanced hits
                # resolve prim -1 and keep the geometric normal.
                slot_to_tri = np.concatenate([slot_to_tri, np.full(
                    (cl.aabb_min.shape[0] - n_base) * cluster_ops.CLUSTER_SIZE,
                    -1, np.int32)])

        # The slot-indexed attribute rows, built LAST, so that slot_to_tri
        # already carries the page remap and the prototype padding.
        attr_pack = None
        if has_attrs:
            s_valid = slot_to_tri >= 0
            s_idx = np.maximum(slot_to_tri, 0)
            attr_pack = np.zeros((slot_to_tri.shape[0], 25), np.float32)
            attr_pack[:, 0] = s_valid
            attr_pack[:, 1:4] = v0[s_idx]
            attr_pack[:, 4:7] = e1[s_idx]
            attr_pack[:, 7:10] = e2[s_idx]
            if attr_shn is not None:
                attr_pack[:, 10:19] = attr_shn[s_idx].reshape(-1, 9)
            if attr_uv is not None:
                attr_pack[:, 19:25] = attr_uv[s_idx].reshape(-1, 6)
            attr_pack *= s_valid[:, None]

        mat_albedo = np.array([m[1] for m in self._mat], np.float32)
        mat_param = np.array([m[2] for m in self._mat], np.float32)
        mat_emit = np.array([m[3] for m in self._mat], np.float32)

        def dev(x, dtype=torch.float32):
            return None if x is None else torch.as_tensor(x, dtype=dtype,
                                                          device=device)

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
        sss = np.array(self._mat_sss, np.float32)
        mat_interior = None
        if (sss[:, 0] > 0.0).any():
            if self._fog is not None or self._vol is not None:
                raise ValueError(
                    "interior scattering and fog/volume grids are "
                    "mutually exclusive (the combined estimator is "
                    "untested)"
                )
            mat_interior = dev(sss)
        mat_param2 = (dev(np.array(self._mat_param2, np.float32))
                      if (mat_type == materials.TYPE_ROUGH_DIELECTRIC).any()
                      else None)
        mat_disp = dev(disp) if (disp > 0.0).any() else None
        mat_aniso = dev(aniso) if (aniso > 0.0).any() else None
        # Texture columns, likewise; the atlas only when some material
        # uses a texture.
        tex_cols = {f: np.array(getattr(self, "_" + f), np.int32)
                    for f in ("mat_tex", "mat_ntex", "mat_mrtex")}
        used = {f: bool((c >= 0).any()) for f, c in tex_cols.items()}
        textures = None
        if self._tex and any(used.values()):
            textures = texture_ops.to_device(
                texture_ops.build_atlas(self._tex, mips=self._mipmaps),
                device)
        tex_fields = {f: dev(c, torch.int32) if textures is not None
                      and used[f] else None for f, c in tex_cols.items()}
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
        if inst_tree is not None:
            inst_tree = dev_all(inst_tree)

        return Scene(
            env=env, delta=lights.build_delta_lights(self._delta, device),
            mat_interior=mat_interior,
            fog=dev(self._fog) if self._fog is not None else None,
            vol=(volume_ops.to_device(self._vol, device)
                 if self._vol is not None else None),
            mat_absorb=mat_absorb, mat_param2=mat_param2, mat_disp=mat_disp,
            mat_aniso=mat_aniso,
            mat_metallic=mat_metallic, mat_clearcoat=mat_clearcoat,
            instances=instances, inst_tree=inst_tree,
            pages=None if pages is None else dev_all(pages),
            sph_center=dev(sph_center), sph_radius=dev(sph_radius),
            sph_mat=dev(sph_mat, torch.int32),
            tri_v0=dev(v0), tri_e1=dev(e1), tri_e2=dev(e2),
            tri_mat=dev(tri_mat, torch.int32),
            bvh=bvh_ops.FlatBVH(dev(node_min), dev(node_max),
                                dev(node_meta, torch.int32)),
            mat_type=dev(mat_type, torch.int32), mat_albedo=dev(mat_albedo),
            mat_param=dev(mat_param), mat_emit=dev(mat_emit),
            clusters=dev_all(cl),
            lights=lights.build_light_table(
                v0, v0 + e1, v0 + e2, tri_mat, mat_type, mat_emit,
                materials.TYPE_EMISSIVE, device,
                sph_center=sph_center, sph_radius=sph_radius,
                sph_mat=sph_mat, tri_uv=attr_uv,
                tri_tex=(tex_cols["mat_tex"][tri_mat] if used["mat_tex"]
                         else None),
            ),
            attr_uv=dev(attr_uv), attr_shn=dev(attr_shn),
            slot_to_tri=dev(slot_to_tri, torch.int32) if has_attrs else None,
            attr_pack=dev(attr_pack), textures=textures, **tex_fields,
        )

    def _place_protos(self, cl, mat_type):
        """Append each prototype's clusters (built in OBJECT space, packed
        per prototype so cluster ranges stay contiguous) after the base
        clusters, then place them. Placements, the base geometry as one
        identity placement first: expanded into an InstanceSet (one row
        per placement and prototype cluster) while that fits
        ``DNF_MAX_CLUSTERS``; past it, when no placement moves, kept in two
        levels (``cluster_ops.build_instance_tree``: one record per
        placement over each prototype's own cluster tree), and a moving
        set past it raises. The combined ClusterSet keeps the base
        geometry's tree fields. Returns (combined ClusterSet, InstanceSet
        or None, InstanceTree or None), numpy."""
        n_base = cl.aabb_min.shape[0]
        eye = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
        placements = [(0, n_base, eye)]
        parts = [cl]
        trees = [(0, cl)]
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
            trees.append((offset, pcl))
            for m, im, m1 in zip(ts, imats, mts):
                placements.append((offset, npc, m, im, m1))
            offset += npc
        cl = cl._replace(**{
            f: np.concatenate([getattr(p, f) for p in parts])
            for f in ("aabb_min", "aabb_max", "woop", "normal", "mat")})
        ce = sum(p[1] for p in placements)
        if ce <= cluster_trace.DNF_MAX_CLUSTERS:
            return cl, cluster_ops.expand_instances(cl, placements), None
        if any(len(p) > 4 and p[4] is not None for p in placements):
            raise ValueError(
                f"{ce} expanded instance clusters exceed the DNF budget "
                f"({cluster_trace.DNF_MAX_CLUSTERS}) and some placements "
                "move (only static placements take the two-level walk); "
                "reduce instance counts or split the scene"
            )
        proto_of = {first: k for k, (first, _) in enumerate(trees)}
        itree = cluster_ops.build_instance_tree(
            trees, [(proto_of[p[0]], p[2], p[3] if len(p) > 3 else -1)
                    for p in placements])
        return cl, None, itree


def has_motion(scene: Scene) -> bool:
    """True when the scene carries motion-blurred instances: the engine
    then draws a per-path shutter time and passes it to every closest-hit
    and shadow query."""
    return scene.instances is not None and scene.instances.fw0 is not None


def uses_mips(scene: Scene) -> bool:
    """True when the texture atlas carries a mip pyramid: the engine then
    carries each path's distance from the camera (the ray cone) and
    shading picks a texture LOD from it."""
    return scene.textures is not None and scene.textures.mip_table is not None


def uses_dnf(scene: Scene) -> bool:
    """True when cluster queries route to a cluster sweep (flat, instanced
    or paged) or to the two-level instanced walk: the megakernel then
    compacts its waves, and shading does not bin their rays, as in the JAX
    package for the sweeps. False only for an unpaged
    scene past ``DNF_MAX_CLUSTERS``, which walks the cluster tree; with
    ``RenderConfig.ray_sort`` that route's queries take their rays in
    (cell, octant) bins (``binning.ray_bin``). A query's result does not
    depend on the order of its rays."""
    return scene.clusters is not None and (
        scene.pages is not None
        or scene.instances is not None
        or scene.inst_tree is not None
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
    # No JAX counterpart: the JAX package expands every placement.
    ("trace", "inst_tree"): (cluster_trace.trace_inst_tree_torch,
                             cluster_trace.trace_inst_tree),
    ("occluded", "inst_tree"): (cluster_trace.occluded_inst_tree_torch,
                                cluster_trace.occluded_inst_tree),
}


def cluster_route(scene: Scene) -> str:
    """Which traversal a scene's cluster queries take: as in the JAX
    package "instanced", "paged", "flat" (at most ``DNF_MAX_CLUSTERS``
    clusters) or "tree" (an unpaged scene past that budget); the port's
    own "inst_tree" (two-level instancing past that budget)."""
    if scene.instances is not None:
        return "instanced"
    if scene.inst_tree is not None:
        return "inst_tree"
    if scene.pages is not None:
        return "paged"
    if scene.clusters.woop.shape[0] <= cluster_trace.DNF_MAX_CLUSTERS:
        return "flat"
    return "tree"


def _cluster_query(scene: Scene, query: str, traversal: str, counts=None):
    """The cluster traversal of this scene under ``traversal``, as a
    function (origin, direction, cap, time) -> result. Instanced scenes
    take the instanced pair (``time`` is the per-ray shutter time of a
    motion set); the other routes ignore ``time``. ``counts``
    (``cluster_trace.walk_counts``, or None) gets the two-level walk's
    counts; the other routes count nothing."""
    route = cluster_route(scene)
    if traversal not in ("cluster_torch", "cluster_cuda"):
        raise ValueError(f"unknown traversal mode: {traversal!r}")
    fn = _ROUTES[query, route][traversal == "cluster_cuda"]
    if route == "instanced":
        return lambda o, d, cap, time: fn(scene.clusters, scene.instances,
                                          o, d, cap, time=time)
    if route == "paged":
        return lambda o, d, cap, time: fn(scene.clusters, scene.pages,
                                          o, d, cap)
    if route == "inst_tree":
        return lambda o, d, cap, time: fn(scene.clusters, scene.inst_tree,
                                          o, d, cap, counts=counts)
    return lambda o, d, cap, time: fn(scene.clusters, o, d, cap)


def surface_attributes(scene: Scene, hit: Hit, cone_width=None):
    """Interpolated shading normal and texture coordinates of a hit batch.

    Returns (normal (R, 3), uv (R, 2)); with ``cone_width`` ((R,) f32, the
    ray cone's world-space width at the hit) also the (R,) UV-per-world
    density sqrt(|det_uv| / |e1 × e2|), and normal-map lookups are
    trilinear at the matching LOD.

    A cluster hit resolves its triangle rows and attributes by ONE gather
    of ``attr_pack`` by its slot; a "bvh" hit (no slot) gathers the row
    arrays by ``prim``. Barycentrics come from the hit point against the
    (v0, e1, e2) rows by elementwise dots (never a matmul). The
    interpolated normal is flipped into the geometric (ray-facing)
    hemisphere; a zero shading-normal row keeps the geometric normal.
    Sphere hits keep their analytic normal and take lat-long uvs from it.
    A tangent-space normal map (``mat_ntex``) perturbs the normal in the
    uv-aligned triangle frame, or the sphere's lat-long frame, built
    around the current shading normal."""
    r = hit.t.shape[0]
    dev = hit.t.device
    if scene.attr_pack is not None and hit.slot is not None:
        safe_slot = torch.clamp(hit.slot, 0, scene.attr_pack.shape[0] - 1)
        pack = scene.attr_pack[safe_slot.long()]
        tri = hit.tri & (pack[:, 0] > 0.0)
        v0, e1, e2 = pack[:, 1:4], pack[:, 4:7], pack[:, 7:10]
        shn = (pack[:, 10:19].reshape(r, 3, 3)
               if scene.attr_shn is not None else None)
        uvs = (pack[:, 19:25].reshape(r, 3, 2)
               if scene.attr_uv is not None else None)
    else:
        tri = hit.tri & (hit.prim >= 0)
        safe = torch.clamp(hit.prim, 0, scene.tri_v0.shape[0] - 1).long()
        v0, e1, e2 = scene.tri_v0[safe], scene.tri_e1[safe], scene.tri_e2[safe]
        shn = scene.attr_shn[safe] if scene.attr_shn is not None else None
        uvs = scene.attr_uv[safe] if scene.attr_uv is not None else None

    # Barycentrics (u along e1, v along e2) from the edge basis.
    p = hit.position - v0
    d11 = linalg.dot(e1, e1)
    d12 = linalg.dot(e1, e2)
    d22 = linalg.dot(e2, e2)
    dp1 = linalg.dot(p, e1)
    dp2 = linalg.dot(p, e2)
    det = torch.clamp(d11 * d22 - d12 * d12, min=1e-20)
    bu = torch.clamp((d22 * dp1 - d12 * dp2) / det, 0.0, 1.0)
    bv = torch.clamp((d11 * dp2 - d12 * dp1) / det, 0.0, 1.0)
    bw = torch.clamp(1.0 - bu - bv, 0.0, 1.0)

    normal = hit.normal
    if shn is not None:
        ns = (bw[:, None] * shn[:, 0] + bu[:, None] * shn[:, 1]
              + bv[:, None] * shn[:, 2])
        len2 = linalg.dot(ns, ns)
        ok = tri & (len2 > 1e-12)
        ns = ns / torch.sqrt(torch.clamp(len2, min=1e-20))[:, None]
        flip = torch.where(linalg.dot(ns, hit.normal) < 0.0, -1.0, 1.0)
        normal = torch.where(ok[:, None], ns * flip[:, None], hit.normal)

    if uvs is not None:
        uv_tri = (bw[:, None] * uvs[:, 0] + bu[:, None] * uvs[:, 1]
                  + bv[:, None] * uvs[:, 2])
    else:
        uv_tri = torch.zeros((r, 2), dtype=torch.float32, device=dev)

    # Spheres: lat-long uvs of the geometric normal.
    n = hit.normal
    su = 0.5 + torch.atan2(n[:, 2], n[:, 0]) * (0.5 / np.pi)
    sv = 0.5 + torch.asin(torch.clamp(n[:, 1], -1.0, 1.0)) * (1.0 / np.pi)
    uv = torch.where(tri[:, None], uv_tri, torch.stack([su, sv], dim=-1))

    dens = lod_base = None
    if cone_width is not None:
        # UV-per-world density for the LOD: the triangle's uv area over
        # its world area, as a length scale (sphere and uv-less hits: 0,
        # so their LOD clamps to level 0).
        if uvs is not None:
            duv1d = uvs[:, 1] - uvs[:, 0]
            duv2d = uvs[:, 2] - uvs[:, 0]
            det_d = torch.abs(duv1d[:, 0] * duv2d[:, 1]
                              - duv2d[:, 0] * duv1d[:, 1])
            c = linalg.cross(e1, e2)
            area_w = torch.sqrt(torch.clamp(linalg.dot(c, c), min=1e-30))
            dens = torch.where(tri, torch.sqrt(det_d / area_w), 0.0)
        else:
            dens = torch.zeros(r, dtype=torch.float32, device=dev)
        lod_base = torch.log2(torch.clamp(cone_width * dens, min=1e-20))

    if scene.mat_ntex is not None and scene.textures is not None:
        ntex_id = scene.mat_ntex[
            torch.clamp(hit.mat_id, 0, scene.mat_ntex.shape[0] - 1).long()]
        if scene.attr_uv is not None:
            duv1 = uvs[:, 1] - uvs[:, 0]
            duv2 = uvs[:, 2] - uvs[:, 0]
        else:
            duv1 = torch.zeros((r, 2), dtype=torch.float32, device=dev)
            duv2 = torch.zeros((r, 2), dtype=torch.float32, device=dev)
        det_uv = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
        inv = 1.0 / torch.where(torch.abs(det_uv) > 1e-12, det_uv, 1.0)
        t_tri = (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) * inv[:, None]
        b_tri = (duv1[:, 0:1] * e2 - duv2[:, 0:1] * e1) * inv[:, None]

        # Sphere frame: T along +phi (the lat-long map's u axis).
        rxz = torch.sqrt(torch.clamp(n[:, 0] * n[:, 0] + n[:, 2] * n[:, 2],
                                     min=1e-20))
        t_sph = torch.stack([-n[:, 2] / rxz, torch.zeros_like(rxz),
                             n[:, 0] / rxz], dim=-1)
        at_pole = rxz < 1e-6
        t_raw = torch.where(tri[:, None], t_tri, t_sph)
        b_raw = torch.where(tri[:, None], b_tri, linalg.cross(normal, t_sph))

        # Gram-Schmidt against the shading normal; the bitangent's sign
        # follows the uv winding.
        t_p = t_raw - normal * linalg.dot(normal, t_raw)[:, None]
        t_len2 = linalg.dot(t_p, t_p)
        t_hat = t_p / torch.sqrt(torch.clamp(t_len2, min=1e-20))[:, None]
        b_cross = linalg.cross(normal, t_hat)
        handed = torch.where(linalg.dot(b_cross, b_raw) < 0.0, -1.0, 1.0)
        b_hat = b_cross * handed[:, None]

        if lod_base is not None and scene.textures.mip_table is not None:
            texel = texture_ops.sample_trilinear(scene.textures, ntex_id, uv,
                                                 lod_base)
        else:
            texel = texture_ops.sample_bilinear(scene.textures, ntex_id, uv)
        tn = 2.0 * texel - 1.0
        n_map = (tn[:, 0:1] * t_hat + tn[:, 1:2] * b_hat
                 + tn[:, 2:3] * normal)
        len2 = linalg.dot(n_map, n_map)
        n_map = n_map / torch.sqrt(torch.clamp(len2, min=1e-20))[:, None]
        flip = torch.where(linalg.dot(n_map, hit.normal) < 0.0, -1.0, 1.0)
        tangent_ok = torch.where(tri, torch.abs(det_uv) > 1e-12, ~at_pole)
        mapped = (hit.valid & (ntex_id >= 0) & tangent_ok
                  & (len2 > 1e-12) & (t_len2 > 1e-12))
        normal = torch.where(mapped[:, None], n_map * flip[:, None], normal)

    if cone_width is not None:
        return normal, uv, dens
    return normal, uv


def intersect_scene(scene: Scene, origin, direction) -> Hit:
    """Closest hit of a (R, 3) ray batch through the threaded BVH (the
    "bvh" route, the JAX package's vmapped ``intersect_scene``): spheres
    by brute force, triangles by ``ops.bvh.traverse`` culled against the
    best sphere t. The Hit carries ``prim`` and no slot."""
    if scene.instances is not None or scene.inst_tree is not None:
        raise ValueError(
            "instanced scenes need a cluster traversal mode (the BVH only "
            "indexes base triangles)"
        )
    ts = _sphere_pass(scene, origin, direction)
    sph_t, sph_idx = torch.min(ts, dim=1)
    tri_t, tri_idx = bvh_ops.traverse(
        scene.bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2, origin,
        direction, sph_t)
    hit_tri = tri_t < sph_t
    t = torch.where(hit_tri, tri_t, sph_t)
    valid = torch.isfinite(t)
    position = origin + t[:, None] * direction

    safe_sph = torch.clamp(sph_idx, max=scene.sph_center.shape[0] - 1)
    n_sph = (position - scene.sph_center[safe_sph]) / torch.clamp(
        scene.sph_radius[safe_sph], min=1e-12)[:, None]
    safe_tri = torch.clamp(tri_idx, 0, scene.tri_v0.shape[0] - 1).long()
    n_tri = linalg.normalize(linalg.cross(scene.tri_e1[safe_tri],
                                          scene.tri_e2[safe_tri]))
    n_geo = torch.where(hit_tri[:, None], n_tri, n_sph)
    front = linalg.dot(direction, n_geo) < 0.0
    normal = torch.where(front[:, None], 1.0, -1.0) * n_geo
    mat_id = torch.where(hit_tri, scene.tri_mat[safe_tri],
                         scene.sph_mat[safe_sph])
    mat_id = torch.where(valid, mat_id, 0).to(torch.int32)
    return Hit(
        t=t, position=position, normal=normal, mat_id=mat_id, front=front,
        valid=valid, tri=hit_tri & valid,
        prim=torch.where(hit_tri & valid, tri_idx, -1).to(torch.int32),
    )


def _binned(scene: Scene, query, origin, direction, cap, time):
    """``query`` on the rays sorted into (coarse cell, direction octant)
    bins over the scene's box (the instances' or placements' boxes, else
    the clusters'), lanes with a zero cap in the last bin; the results
    come back in the rays' own order."""
    src = next(x for x in (scene.instances, scene.inst_tree, scene.clusters)
               if x is not None)
    lo = torch.amin(src.aabb_min, dim=0)
    hi = torch.amax(src.aabb_max, dim=0)
    bins = binning.ray_bin(origin, direction, lo, hi, cap > 0.0)
    perm, inv = binning.binning_perm(bins, binning.N_BINS)
    out = query(origin[perm], direction[perm], cap[perm],
                None if time is None else time[perm])
    if isinstance(out, tuple):
        return tuple(x[inv] for x in out)
    return out[inv]


@metrics.traced("trace.occluded")
def occluded_batch(scene: Scene, origin, direction, t_max,
                   traversal: str, active=None, time=None,
                   bin_rays: bool = False, counts=None):
    """Any-hit occlusion for a (R, 3) ray batch: True where any primitive
    lies strictly inside (T_MIN, t_max). Lanes the sphere pass already
    occluded, and inactive lanes, get a zero cap so the cluster sweep
    skips them (the result ORs the sphere answer back in). ``time``
    (optional (R,)): per-ray shutter time for motion-blurred instances.
    ``bin_rays``: the cluster query takes its rays in bins
    (``_binned``). ``counts``: as ``_cluster_query``'s. The "bvh" route
    answers with its closest hit, ``t < t_max``, as the JAX package does,
    and does not bin."""
    if traversal == "bvh":
        hit = intersect_scene(scene, origin, direction)
        occ = hit.valid & (hit.t < t_max)
        return occ & active if active is not None else occ
    query = _cluster_query(scene, "occluded", traversal, counts)
    ts = _sphere_pass(scene, origin, direction)
    occ_sph = torch.min(ts, dim=1).values < t_max
    if active is not None:
        occ_sph = occ_sph & active
    cap = t_max
    if active is not None:
        cap = torch.where(active, cap, 0.0)
    cap = torch.where(occ_sph, 0.0, cap)
    if bin_rays:
        return occ_sph | _binned(scene, query, origin, direction, cap, time)
    return occ_sph | query(origin, direction, cap, time)


@metrics.traced("trace.closest")
def intersect_batch(scene: Scene, origin, direction, traversal: str,
                    active=None, t_max=None, time=None,
                    bin_rays: bool = False, counts=None) -> Hit:
    """Closest hit for a whole (R, 3) ray batch. Spheres first (their best
    t culls the cluster sweep); ``active`` (optional (R,) bool) gives dead
    lanes ``t_init = 0``, and their Hit fields are garbage the callers
    mask. ``time`` (optional (R,)): per-ray shutter time for
    motion-blurred instances. ``bin_rays``: the cluster query takes its
    rays in bins (``_binned``). ``counts``: as ``_cluster_query``'s. The
    "bvh" route (``intersect_scene``) ignores ``active``, ``t_max``,
    ``time``, ``bin_rays`` and ``counts``, as the JAX package's does. ``prim`` resolves a cluster hit's slot through
    ``slot_to_tri`` where the scene has it (-1 elsewhere, with no
    gather)."""
    if traversal == "bvh":
        return intersect_scene(scene, origin, direction)
    query = _cluster_query(scene, "trace", traversal, counts)
    ts = _sphere_pass(scene, origin, direction)               # (R, S)
    sph_t, sph_idx = torch.min(ts, dim=1)
    t_init = torch.where(torch.isfinite(sph_t), sph_t, 3.0e38)
    if t_max is not None:
        t_init = torch.minimum(t_init, t_max)
    if active is not None:
        t_init = torch.where(active, t_init, 0.0)

    if bin_rays:
        tri_t, slot, n_tri, mat_tri = _binned(scene, query, origin, direction,
                                              t_init, time)
    else:
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
    tri = hit_tri & valid
    if scene.slot_to_tri is not None:
        safe_slot = torch.clamp(slot, 0, scene.slot_to_tri.shape[0] - 1)
        prim = torch.where(tri, scene.slot_to_tri[safe_slot.long()], -1)
    else:
        prim = torch.full_like(slot, -1)
    return Hit(
        t=t, position=position, normal=normal, mat_id=mat_id, front=front,
        valid=valid, tri=tri, prim=prim.to(torch.int32),
        slot=torch.where(tri, slot, -1).to(torch.int32),
    )
