"""JSON scene descriptions (the JAX package's ``models/scene_io.py``, host
numpy): a scene file compiles through the port's ``SceneBuilder`` into
the device tables.

Format (see ``tests/test_scene_io.py`` or ``examples/`` for a sample):

{
  "camera":   {"position": [x,y,z], "look_at": [..], "vfov_degrees": 40,
               "up": [..], "aperture": 0.0, "focus_distance": 1.0,
               "projection": "pinhole",
               "motion": {"position": [..], "look_at": [..]}},
  "materials": {
    "white": {"type": "lambertian", "albedo": [r,g,b]},
    "bumpy": {"type": "lambertian", "albedo": [..],
              "normal_map": "ripples.png"},
    "mirror": {"type": "metal", "albedo": [..], "fuzz": 0.05},
    "glass":  {"type": "dielectric", "ior": 1.5, "tint": [1,1,1]},
    "frost":  {"type": "dielectric", "ior": 1.5, "roughness": 0.15},
    "paint":  {"type": "principled", "base_color": [..],
               "metallic": 0.3, "roughness": 0.4},
    "lamp":   {"type": "emissive", "radiance": [15,15,15]}
  },
  "objects": [
    {"type": "sphere", "center": [..], "radius": 0.5, "material": "white"},
    {"type": "quad", "corner": [..], "edge_u": [..], "edge_v": [..],
     "material": "white"},
    {"type": "triangle", "v0": [..], "v1": [..], "v2": [..],
     "material": "white"},
    {"type": "mesh", "obj": "bunny.obj", "material": "white",
     "fit_box": {"center": [0,-0.5,0], "size": 1.0},
     "transform": {"scale": 1, "rotate_y_degrees": 0,
                   "translate": [0,0,0]}},
    {"type": "mesh", "ply": "dragon.ply", "material": "white"},
    {"type": "icosphere", "subdivisions": 4, "radius": 0.5,
     "center": [0,0,0], "material": "white"},
    {"type": "instances", "material": "white",
     "obj": "tree.obj",                       # or "icosphere": {...}
     "transforms": [
       {"scale": [1,1.2,1], "rotate_y_degrees": 30, "translate": [..]},
       {"matrix": [[..4 cols..], [..], [..]]}
     ]}
  ]
}

An optional top-level ``"delta_lights"`` list adds zero-extent emitters
(pure-NEE; see ``ops.lights.DeltaLights``):

  {"type": "point", "position": [..], "intensity": [r,g,b]}
  {"type": "spot", "position": [..], "direction": [..],
   "intensity": [..], "inner_degrees": 20, "outer_degrees": 30}
  {"type": "directional", "direction": [..], "irradiance": [r,g,b]}

An optional top-level ``"background": "gradient"`` names the sky used
for escaped rays when the CLI runs with ``--background auto`` (the
default) — emitter-free outdoor scenes want "gradient", lit interiors
the default "black".

An optional top-level ``environment`` attaches an image-based light
(``ops/envmap.py``), one of:

  "environment": {"image": "probe.hdr", "scale": 1.0,
                  "rotate_degrees": 0}
  "environment": {"sky": {"sun_direction": [..], ...sky_texels kwargs}}
  "environment": {"uniform": [r, g, b]}

Relative mesh/HDR paths resolve against the JSON file's directory.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from pathtracing_tpu_torch.models import meshes
from pathtracing_tpu_torch.models import scenes as scenes_mod
from pathtracing_tpu_torch.models.scene import Scene, SceneBuilder
from pathtracing_tpu_torch.ops import envmap as envmap_ops
from pathtracing_tpu_torch.utils.config import CameraConfig


def _affine(t) -> np.ndarray:
    """One instance transform spec → (3, 4) object→world matrix. Either
    ``{"matrix": 3x4 | 4x4}`` verbatim, or components applied in the
    conventional scale → rotate-about-y → translate order."""
    if "matrix" in t:
        m = np.asarray(t["matrix"], np.float64)
        if m.shape == (4, 4):
            m = m[:3]
        if m.shape != (3, 4):
            raise ValueError(
                f"instance matrix must be 3x4 or 4x4; got {m.shape}"
            )
        return m
    s = t.get("scale", 1.0)
    s = np.diag([s, s, s] if np.isscalar(s) else list(s))
    a = np.radians(float(t.get("rotate_y_degrees", 0.0)))
    c, sn = np.cos(a), np.sin(a)
    rot = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]])
    tr = np.asarray(t.get("translate", (0.0, 0.0, 0.0)), np.float64)
    return np.concatenate([rot @ s, tr[:, None]], axis=1)


def preferred_background(path: str) -> str:
    """Top-level ``"background"`` key ("black" | "gradient" | "white")
    consumed by the CLI's ``--background auto`` default; scenes without
    one render against black."""
    with open(path) as f:
        bg = json.load(f).get("background", "black")
    if bg not in ("black", "gradient", "white"):
        raise ValueError(f"unknown background {bg!r} in {path}")
    return bg


def load_scene(path: str, device=None) -> Tuple[Scene, CameraConfig]:
    """Load a JSON scene file into a Scene built on ``device`` (the card
    unless the caller asks for another device) and its CameraConfig."""
    with open(path) as f:
        spec = json.load(f)
    base_dir = os.path.dirname(os.path.abspath(path))

    cam_spec = spec.get("camera", {})
    camera = CameraConfig(
        position=tuple(cam_spec.get("position", (0.0, 0.0, 1.0))),
        look_at=tuple(cam_spec.get("look_at", (0.0, 0.0, 0.0))),
        up=tuple(cam_spec.get("up", (0.0, 1.0, 0.0))),
        vfov_degrees=float(cam_spec.get("vfov_degrees", 90.0)),
        aperture=float(cam_spec.get("aperture", 0.0)),
        focus_distance=float(cam_spec.get("focus_distance", 1.0)),
        projection=str(cam_spec.get("projection", "pinhole")),
        motion_position=(tuple(cam_spec["motion"]["position"])
                         if "position" in cam_spec.get("motion", {})
                         else None),
        motion_look_at=(tuple(cam_spec["motion"]["look_at"])
                        if "look_at" in cam_spec.get("motion", {})
                        else None),
    )

    b = SceneBuilder()
    mat_ids = {}
    for name, m in spec.get("materials", {}).items():
        mtype = m["type"]
        # Optional "texture": image path (resolved against the JSON's
        # directory) whose linear color modulates the albedo at UV-mapped
        # hits (lambertian / metal / ggx).
        tex = m.get("texture")
        if tex is not None and not os.path.isabs(tex):
            tex = os.path.join(base_dir, tex)
        # Optional "normal_map": tangent-space map path (8-bit files
        # load linearly — direction data, not color).
        nmap = m.get("normal_map")
        if nmap is not None and not os.path.isabs(nmap):
            nmap = os.path.join(base_dir, nmap)
        if mtype == "lambertian":
            mat_ids[name] = b.lambertian(
                m.get("albedo", (1.0, 1.0, 1.0)), texture=tex,
                normal_map=nmap,
            )
        elif mtype == "metal":
            mat_ids[name] = b.metal(
                m["albedo"], m.get("fuzz", 0.0), texture=tex,
                normal_map=nmap,
            )
        elif mtype == "dielectric":
            # "roughness" > 0 selects the microfacet (Walter 2007)
            # glass: frosted reflections and refractions.
            mat_ids[name] = b.dielectric(
                m.get("ior", 1.5), m.get("tint", (1.0, 1.0, 1.0)),
                absorption=m.get("absorption", (0.0, 0.0, 0.0)),
                roughness=m.get("roughness", 0.0),
                dispersion=m.get("dispersion", 0.0),
                scattering=m.get("scattering", 0.0),
                scatter_g=m.get("scatter_g", 0.0),
            )
        elif mtype == "emissive":
            mat_ids[name] = b.emissive(m["radiance"], texture=tex)
        elif mtype == "ggx":
            mat_ids[name] = b.ggx(
                m["albedo"], m.get("roughness", 0.1), texture=tex,
                normal_map=nmap,
                anisotropy=m.get("anisotropy", 0.0),
            )
        elif mtype == "principled":
            # Optional "mr_texture": metallic-roughness map path (glTF
            # channels — G scales roughness, B scales metallic; loaded
            # linearly like the normal map).
            mrt = m.get("mr_texture")
            if mrt is not None and not os.path.isabs(mrt):
                mrt = os.path.join(base_dir, mrt)
            mat_ids[name] = b.principled(
                m.get("base_color", (0.8, 0.8, 0.8)),
                metallic=m.get("metallic", 0.0),
                roughness=m.get("roughness", 0.5),
                texture=tex, normal_map=nmap, mr_texture=mrt,
                clearcoat=m.get("clearcoat", 0.0),
                clearcoat_roughness=m.get("clearcoat_roughness", 0.1),
            )
        elif mtype == "checker":
            mat_ids[name] = b.checker(
                m["color1"], m["color2"], m.get("frequency", 3.0)
            )
        else:
            raise ValueError(f"unknown material type {mtype!r} ({name})")

    def mat(obj):
        name = obj["material"]
        if name not in mat_ids:
            raise ValueError(f"object references unknown material {name!r}")
        return mat_ids[name]

    for obj in spec.get("objects", []):
        otype = obj["type"]
        if otype == "sphere":
            b.add_sphere(obj["center"], obj["radius"], mat(obj))
        elif otype == "quad":
            b.add_quad(obj["corner"], obj["edge_u"], obj["edge_v"],
                       mat(obj), uv=bool(obj.get("uv", False)))
        elif otype == "triangle":
            b.add_triangle(obj["v0"], obj["v1"], obj["v2"], mat(obj),
                           uv=obj.get("uv"))
        elif otype == "mesh":
            mesh_path = obj.get("obj", obj.get("ply"))
            if mesh_path is None:
                raise ValueError("mesh object needs an 'obj' or 'ply' path")
            if not os.path.isabs(mesh_path):
                mesh_path = os.path.join(base_dir, mesh_path)
            loader = (meshes.load_ply
                      if mesh_path.lower().endswith(".ply")
                      else meshes.load_obj_full)
            verts, faces, uvs, uvf, norms, nrf = loader(mesh_path)
            if "fit_box" in obj:
                fb = obj["fit_box"]
                verts = meshes.fit_to_box(verts, fb["center"], fb["size"])
            if "transform" in obj:
                verts = meshes.transform(verts, **obj["transform"])
                if norms is not None:
                    # Normals rotate but never scale/translate.
                    norms = meshes.transform(
                        norms,
                        rotate_y_degrees=obj["transform"].get(
                            "rotate_y_degrees", 0.0
                        ),
                    )
            b.add_mesh(verts, faces, mat(obj),
                       uvs=uvs, uv_faces=uvf,
                       normals=norms, normal_faces=nrf,
                       smooth=bool(obj.get("smooth", False)))
        elif otype == "icosphere":
            verts, faces = scenes_mod.icosphere(
                obj.get("subdivisions", 4), obj.get("radius", 1.0)
            )
            verts = verts + np.asarray(obj.get("center", (0, 0, 0)),
                                       np.float64)
            b.add_mesh(verts, faces, mat(obj),
                       smooth=bool(obj.get("smooth", False)))
        elif otype == "instances":
            # Shared-geometry instancing (SceneBuilder.add_instances):
            # one prototype mesh ("obj" path or "icosphere" kwargs) and
            # a list of transforms, each either component form
            # {"scale": s | [sx,sy,sz], "rotate_y_degrees": a,
            #  "translate": [x,y,z]} or a raw {"matrix": 3x4 | 4x4}.
            if "obj" in obj:
                mesh_path = obj["obj"]
                if not os.path.isabs(mesh_path):
                    mesh_path = os.path.join(base_dir, mesh_path)
                verts, faces = meshes.load_obj(mesh_path)
                if "fit_box" in obj:
                    fb = obj["fit_box"]
                    verts = meshes.fit_to_box(
                        verts, fb["center"], fb["size"]
                    )
            else:
                ico = obj.get("icosphere", {})
                verts, faces = scenes_mod.icosphere(
                    ico.get("subdivisions", 3), ico.get("radius", 1.0)
                )
            # Optional "materials": one material name (or null) per
            # transform, overriding the prototype's material for that
            # instance (per-instance colored copies).
            overrides = None
            if "materials" in obj:
                overrides = [
                    mat_ids[n] if n is not None else None
                    for n in obj["materials"]
                ]
            # Optional "motion_transforms": one shutter-close transform
            # (or null = static) per entry of "transforms" — object
            # motion blur (forward-affine lerp at the path's shutter
            # time).
            motion = None
            if "motion_transforms" in obj:
                motion = [
                    None if t is None else _affine(t)
                    for t in obj["motion_transforms"]
                ]
            b.add_instances(
                verts, faces, mat(obj),
                [_affine(t) for t in obj["transforms"]],
                materials=overrides, motion_transforms=motion,
            )
        else:
            raise ValueError(f"unknown object type {otype!r}")

    if "environment" in spec:
        b.environment(
            envmap_ops.environment_texels(spec["environment"], base_dir)
        )

    if "fog" in spec:
        f = spec["fog"]
        b.set_fog(float(f.get("sigma_s", 0.0)),
                  float(f.get("sigma_a", 0.0)),
                  float(f.get("g", 0.0)))

    if "volume" in spec:
        # Heterogeneous voxel-grid medium (ops.volume): the density is
        # either an (Nz, Ny, Nx) .npy path (relative to the scene file)
        # or the name of a built-in procedural grid ("smoke").
        v = spec["volume"]
        dens_spec = v["density"]
        if dens_spec == "smoke":
            dens = scenes_mod.smoke_density(
                res=int(v.get("resolution", 48)),
                seed=int(v.get("seed", 7)),
            )
        else:
            dens = np.load(os.path.join(base_dir, dens_spec))
        emission = None
        if "emission" in v:
            # Emission grid: an .npy path, or "density^2" / "density"
            # derived from the density grid (the fire idiom).
            e = v["emission"]
            if e == "density":
                emission = dens
            elif e == "density^2":
                emission = np.asarray(dens) * np.asarray(dens)
            else:
                emission = np.load(os.path.join(base_dir, e))
        b.set_volume(
            dens, bbox_min=tuple(v["bbox_min"]),
            bbox_max=tuple(v["bbox_max"]),
            sigma_s=float(v.get("sigma_s", 0.0)),
            sigma_a=float(v.get("sigma_a", 0.0)),
            g=float(v.get("g", 0.0)),
            emission=emission,
            emit_color=(tuple(v["emit_color"])
                        if "emit_color" in v else None),
        )

    if spec.get("mipmaps"):
        b.set_mipmaps(True)

    for dl in spec.get("delta_lights", []):
        t = dl.get("type")
        if t == "point":
            b.point_light(dl["position"], dl["intensity"])
        elif t == "spot":
            b.spot_light(
                dl["position"], dl["direction"], dl["intensity"],
                inner_degrees=float(dl.get("inner_degrees", 20.0)),
                outer_degrees=float(dl.get("outer_degrees", 30.0)),
            )
        elif t == "directional":
            b.directional_light(
                dl["direction"], dl.get("irradiance", dl.get("intensity"))
            )
        else:
            raise ValueError(f"unknown delta light type {t!r}")

    return b.build(device), camera
