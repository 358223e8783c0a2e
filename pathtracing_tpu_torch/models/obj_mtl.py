"""Wavefront OBJ + MTL scene loading (the JAX package's
``models/obj_mtl.py``, host numpy): an OBJ file with its own
``mtllib``/``usemtl`` material bindings into the port's ``SceneBuilder``.

MTL's Phong model maps onto the material table by the usual conventions:

* ``Ke`` > 0 (or ``map_Ke``)          -> emissive(Ke) [+ textured emission]
* ``d`` < 1 / ``Tr`` > 0 / illum 4-9  -> dielectric(ior=Ni, tint=Kd-or-white)
* mirror-ish (illum 3/5, Ks dominant,
  high ``Ns``)                        -> ggx(f0=Ks, roughness from Ns)
* everything else                     -> principled(base_color=Kd,
                                          roughness from Ns, metallic=0)
* ``map_Kd`` -> base-colour texture (sRGB), ``map_Bump``/``bump``/``norm``
  -> tangent-space normal map (linear), ``map_Ke`` -> emission texture.

``Ns`` (Blinn-Phong exponent) converts to GGX alpha as
alpha = sqrt(2 / (Ns + 2)); ``principled``'s roughness is perceptual
(alpha = r^2). OBJ has no camera, so the scene is framed as a camera-less
glTF asset is. Faces are grouped by material, one ``add_mesh`` chunk a
group, each with its own all-or-nothing attribute contract.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from pathtracing_tpu_torch.models.gltf import _auto_camera
from pathtracing_tpu_torch.models.scene import Scene, SceneBuilder
from pathtracing_tpu_torch.utils import logging as ptlog
from pathtracing_tpu_torch.utils.config import CameraConfig


# -- OBJ parsing (usemtl-aware) ------------------------------------------------

class _Group:
    """Faces sharing one material binding."""

    def __init__(self, material: Optional[str]):
        self.material = material
        self.faces: List[Tuple[int, int, int]] = []
        self.uvf: List[Tuple[int, int, int]] = []
        self.nrf: List[Tuple[int, int, int]] = []
        self.uv_ok = True
        self.nr_ok = True


def parse_obj(path: str):
    """Parse an OBJ keeping material bindings.

    Returns (vertices (V,3) f64, uvs (U,2) f64, normals (M,3) f64,
    groups: list of _Group, mtllibs: list of str). Polygons are
    fan-triangulated; indices may be negative (relative).
    """
    verts: List[Tuple[float, float, float]] = []
    uvs: List[Tuple[float, float]] = []
    norms: List[Tuple[float, float, float]] = []
    mtllibs: List[str] = []
    groups: List[_Group] = []
    cur = _Group(None)
    groups.append(cur)

    def resolve(raw: str, count: int):
        if not raw:
            return None
        i = int(raw)
        return i - 1 if i > 0 else count + i

    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("vt "):
                p = line.split()
                uvs.append((float(p[1]), float(p[2]) if len(p) > 2 else 0.0))
            elif line.startswith("vn "):
                p = line.split()
                norms.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("usemtl"):
                name = line.split(None, 1)[1].strip() if " " in line else None
                if cur.faces or cur.material != name:
                    cur = _Group(name)
                    groups.append(cur)
                else:
                    cur.material = name
            elif line.startswith("mtllib"):
                # Spec allows several space-separated library files.
                mtllibs.extend(line.split()[1:])
            elif line.startswith("f "):
                vi, ti, ni = [], [], []
                for token in line.split()[1:]:
                    comps = token.split("/")
                    vi.append(resolve(comps[0], len(verts)))
                    ti.append(resolve(comps[1], len(uvs))
                              if len(comps) > 1 else None)
                    ni.append(resolve(comps[2], len(norms))
                              if len(comps) > 2 else None)
                for k in range(1, len(vi) - 1):   # fan triangulation
                    cur.faces.append((vi[0], vi[k], vi[k + 1]))
                    if ti[0] is None or ti[k] is None or ti[k + 1] is None:
                        cur.uv_ok = False
                    else:
                        cur.uvf.append((ti[0], ti[k], ti[k + 1]))
                    if ni[0] is None or ni[k] is None or ni[k + 1] is None:
                        cur.nr_ok = False
                    else:
                        cur.nrf.append((ni[0], ni[k], ni[k + 1]))

    groups = [g for g in groups if g.faces]
    if not verts or not groups:
        raise ValueError(f"OBJ file {path!r} has no triangles")
    return (
        np.asarray(verts, np.float64),
        np.asarray(uvs, np.float64) if uvs else None,
        np.asarray(norms, np.float64) if norms else None,
        groups,
        mtllibs,
    )


# -- MTL parsing ---------------------------------------------------------------

def parse_mtl(path: str) -> Dict[str, dict]:
    """Parse one .mtl library into {material name: {key: value}}.

    Color keys (Kd/Ks/Ke) -> 3-tuples; scalar keys (Ns/Ni/d/Tr/illum)
    -> floats; map keys (map_Kd/map_Ke/map_Bump/bump/norm) -> file
    paths resolved relative to the .mtl file. Unknown keys are ignored
    (the format has decades of vendor extensions).
    """
    base_dir = os.path.dirname(os.path.abspath(path))
    mats: Dict[str, dict] = {}
    cur: Optional[dict] = None
    color_keys = {"kd": "Kd", "ks": "Ks", "ke": "Ke", "tf": "Tf"}
    scalar_keys = {"ns": "Ns", "ni": "Ni", "d": "d", "tr": "Tr",
                   "illum": "illum"}
    map_keys = {"map_kd": "map_Kd", "map_ke": "map_Ke",
                "map_bump": "map_Bump", "bump": "map_Bump",
                "norm": "map_Bump"}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0].lower()
            if key == "newmtl":
                cur = {}
                mats[parts[1] if len(parts) > 1 else ""] = cur
            elif cur is None:
                continue
            elif key in color_keys and len(parts) >= 4:
                cur[color_keys[key]] = (
                    float(parts[1]), float(parts[2]), float(parts[3])
                )
            elif key in scalar_keys and len(parts) >= 2:
                cur[scalar_keys[key]] = float(parts[1])
            elif key in map_keys:
                # Drop -options (e.g. "bump -bm 0.5 file.png"): the last
                # token is the filename by convention.
                cur[map_keys[key]] = os.path.join(base_dir, parts[-1])
    return mats


def _ns_to_roughness(ns: float) -> float:
    """Blinn-Phong exponent -> perceptual roughness (alpha = r^2,
    alpha = sqrt(2/(Ns+2)) energy-matching rule)."""
    alpha = float(np.sqrt(2.0 / (max(ns, 0.0) + 2.0)))
    return float(np.clip(np.sqrt(alpha), 0.02, 1.0))


def _maybe_path(p: Optional[str]) -> Optional[str]:
    if p is not None and not os.path.exists(p):
        ptlog.log_warning("MTL texture %s not found; ignored", p)
        return None
    return p


def build_material(b: SceneBuilder, m: dict) -> int:
    """Map one parsed MTL definition onto the material table."""
    kd = m.get("Kd", (0.8, 0.8, 0.8))
    ks = m.get("Ks", (0.0, 0.0, 0.0))
    ke = m.get("Ke", (0.0, 0.0, 0.0))
    ns = float(m.get("Ns", 10.0))
    illum = int(m.get("illum", 2))
    # Dissolve: d is opacity, Tr = 1 - d (both appear in the wild).
    opacity = float(m.get("d", 1.0 - float(m.get("Tr", 0.0))))
    map_kd = _maybe_path(m.get("map_Kd"))
    map_ke = _maybe_path(m.get("map_Ke"))
    map_bump = _maybe_path(m.get("map_Bump"))

    if max(ke) > 0.0 or map_ke is not None:
        radiance = ke if max(ke) > 0.0 else (1.0, 1.0, 1.0)
        return b.emissive(radiance, texture=map_ke)

    if opacity < 1.0 or illum in (4, 6, 7, 9):
        ior = float(m.get("Ni", 1.5))
        # Tf (transmission filter) is the classic tint channel; fall
        # back to Kd when a non-white one isn't given.
        tf = m.get("Tf", kd if max(kd) > 0.0 else (1.0, 1.0, 1.0))
        return b.dielectric(ior=ior if ior > 1.0 else 1.5,
                            tint=tuple(float(c) for c in tf))

    mirror_like = illum in (3, 5) or (max(ks) > 0.25 and max(kd) < 0.05)
    if mirror_like and max(ks) > 0.0:
        return b.ggx(tuple(float(c) for c in ks),
                     roughness=max(_ns_to_roughness(ns) ** 2, 0.02),
                     normal_map=map_bump)

    if illum <= 1 or max(ks) <= 0.0:
        # Pure diffuse (no specular term authored): Lambertian, not
        # principled — a fabricated glossy lobe would change the look
        # AND the variance of classic diffuse-walled assets.
        return b.lambertian(tuple(float(c) for c in kd),
                            texture=map_kd, normal_map=map_bump)

    return b.principled(
        tuple(float(c) for c in kd),
        metallic=0.0,
        roughness=_ns_to_roughness(ns),
        texture=map_kd,
        normal_map=map_bump,
    )


# -- entry ---------------------------------------------------------------------

def load_obj_scene(path: str, device=None) -> Tuple[Scene, CameraConfig]:
    """Load a .obj (and its .mtl libraries) into a Scene built on
    ``device`` (the card unless the caller asks for another device) and a
    camera."""
    verts, uvs, norms, groups, mtllibs = parse_obj(path)
    base_dir = os.path.dirname(os.path.abspath(path))

    mtl: Dict[str, dict] = {}
    for lib in mtllibs:
        lib_path = os.path.join(base_dir, lib)
        if not os.path.exists(lib_path):
            ptlog.log_warning("mtllib %s not found; materials default",
                              lib_path)
            continue
        mtl.update(parse_mtl(lib_path))

    b = SceneBuilder()
    mat_cache: Dict[Optional[str], int] = {}

    def material_id(name: Optional[str]) -> int:
        if name not in mat_cache:
            if name in mtl:
                mat_cache[name] = build_material(b, mtl[name])
            else:
                if name is not None:
                    ptlog.log_warning("usemtl %s not in any mtllib; "
                                      "using default", name)
                mat_cache[name] = b.lambertian((0.73, 0.73, 0.73))
        return mat_cache[name]

    for g in groups:
        faces = np.asarray(g.faces, np.int64)
        has_uv = (g.uv_ok and uvs is not None
                  and len(g.uvf) == len(g.faces))
        has_nr = (g.nr_ok and norms is not None
                  and len(g.nrf) == len(g.faces))
        b.add_mesh(
            verts, faces, material_id(g.material),
            uvs=uvs if has_uv else None,
            uv_faces=np.asarray(g.uvf, np.int64) if has_uv else None,
            normals=norms if has_nr else None,
            normal_faces=np.asarray(g.nrf, np.int64) if has_nr else None,
        )

    scene = b.build(device)
    used = verts[np.unique(np.concatenate(
        [np.asarray(g.faces, np.int64).ravel() for g in groups]
    ))]
    return scene, _auto_camera([used])
