"""glTF 2.0 scene loader (the JAX package's ``models/gltf.py``, host
numpy): ``.gltf`` and ``.glb`` assets into the port's ``SceneBuilder``.

* triangle primitives (indexed or not), node transforms and the scene
  graph; meshes used more than once without vertex attributes become
  instances (``SceneBuilder.add_instances``), the rest expand per use;
* positions, TEXCOORD_0 and NORMAL (smooth shading);
* metallic-roughness PBR materials (``SceneBuilder.principled``) with
  base-colour, normal and metallic-roughness textures, emissive and
  transmissive materials;
* KHR_lights_punctual lights (delta lights);
* the first perspective camera node as a ``CameraConfig`` (else the
  bounding box is framed automatically).
"""

from __future__ import annotations

import base64
import io
import json
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from pathtracing_tpu_torch.models.scene import Scene, SceneBuilder
from pathtracing_tpu_torch.utils.config import CameraConfig

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_LANES = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}


class _Asset:
    """Parsed container: the glTF JSON dict + resolved binary buffers."""

    def __init__(self, gltf: dict, buffers: List[bytes], base_dir: str):
        self.gltf = gltf
        self.buffers = buffers
        self.base_dir = base_dir
        self._image_cache: Dict[Tuple[int, bool], object] = {}

    # -- accessors ----------------------------------------------------------
    def accessor(self, idx: int) -> np.ndarray:
        """Accessor → (count, lanes) ndarray (f32 for float/normalized,
        original integer dtype otherwise)."""
        acc = self.gltf["accessors"][idx]
        if "sparse" in acc:
            raise ValueError("sparse accessors are not supported")
        lanes = _TYPE_LANES[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        count = int(acc["count"])
        if "bufferView" not in acc:   # spec: zeros
            return np.zeros((count, lanes), dtype)
        view = self.gltf["bufferViews"][acc["bufferView"]]
        buf = self.buffers[view["buffer"]]
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        itemsize = np.dtype(dtype).itemsize
        tight = lanes * itemsize
        stride = view.get("byteStride", tight) or tight
        if stride == tight:
            out = np.frombuffer(
                buf, dtype, count=count * lanes, offset=start
            ).reshape(count, lanes)
        else:
            raw = np.frombuffer(
                buf, np.uint8, count=(count - 1) * stride + tight,
                offset=start,
            )
            idx2 = (np.arange(count)[:, None] * stride
                    + np.arange(tight)[None, :])
            out = raw[idx2].copy().view(dtype).reshape(count, lanes)
        if acc.get("normalized") and not np.issubdtype(dtype, np.floating):
            info = np.iinfo(dtype)
            out = np.maximum(out.astype(np.float32) / info.max, -1.0)
        return out

    # -- images -------------------------------------------------------------
    def image(self, image_idx: int, srgb: bool):
        """glTF image → linear float (H, W, 3) array or a file path
        (paths let ``SceneBuilder.add_texture`` do its own loading)."""
        key = (image_idx, srgb)
        if key in self._image_cache:
            return self._image_cache[key]
        img = self.gltf["images"][image_idx]
        uri = img.get("uri")
        if uri is not None and not uri.startswith("data:"):
            path = os.path.join(self.base_dir, _unquote(uri))
            self._image_cache[key] = path
            return path
        if uri is not None:           # data URI
            data = base64.b64decode(uri.split(",", 1)[1])
        else:                          # embedded bufferView
            view = self.gltf["bufferViews"][img["bufferView"]]
            start = view.get("byteOffset", 0)
            data = self.buffers[view["buffer"]][
                start:start + view["byteLength"]
            ]
        from PIL import Image

        with Image.open(io.BytesIO(data)) as im:
            arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
        if srgb:
            arr = np.where(
                arr <= 0.04045, arr / 12.92,
                ((arr + 0.055) / 1.055) ** 2.4,
            ).astype(np.float32)
        self._image_cache[key] = arr
        return arr


def _unquote(uri: str) -> str:
    from urllib.parse import unquote

    return unquote(uri)


def _read_container(path: str) -> Tuple[dict, Optional[bytes]]:
    """.gltf → (json, None); .glb → (json, BIN chunk or None)."""
    with open(path, "rb") as f:
        head = f.read(4)
        f.seek(0)
        if head != b"glTF":
            return json.load(io.TextIOWrapper(f, "utf-8")), None
        magic, version, _length = struct.unpack("<4sII", f.read(12))
        if version != 2:
            raise ValueError(f"unsupported glb version {version}")
        gltf = None
        bin_chunk = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            clen, ctype = struct.unpack("<I4s", hdr)
            payload = f.read(clen)
            if ctype == b"JSON":
                gltf = json.loads(payload.decode("utf-8"))
            elif ctype == b"BIN\x00":
                bin_chunk = payload
        if gltf is None:
            raise ValueError("glb file has no JSON chunk")
        return gltf, bin_chunk


def _load_buffers(gltf: dict, bin_chunk: Optional[bytes],
                  base_dir: str) -> List[bytes]:
    out = []
    for i, buf in enumerate(gltf.get("buffers", [])):
        uri = buf.get("uri")
        if uri is None:
            if bin_chunk is None:
                raise ValueError(f"buffer {i} has no uri and no BIN chunk")
            out.append(bin_chunk)
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, _unquote(uri)), "rb") as f:
                out.append(f.read())
    return out


# -- node transforms ---------------------------------------------------------

def _quat_matrix(q) -> np.ndarray:
    """glTF (x, y, z, w) unit quaternion → 3×3 rotation."""
    x, y, z, w = (float(v) for v in q)
    n = np.sqrt(x * x + y * y + z * z + w * w) or 1.0
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _node_local(node: dict) -> np.ndarray:
    if "matrix" in node:
        # glTF matrices are column-major.
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    rot = _quat_matrix(node.get("rotation", (0, 0, 0, 1)))
    scale = np.diag(np.asarray(node.get("scale", (1, 1, 1)), np.float64))
    m[:3, :3] = rot @ scale
    m[:3, 3] = np.asarray(node.get("translation", (0, 0, 0)), np.float64)
    return m


def _walk_nodes(gltf: dict):
    """Yield (node dict, world 4×4) over the default scene, depth-first."""
    scenes = gltf.get("scenes", [])
    idx = gltf.get("scene", 0)
    roots = scenes[idx]["nodes"] if scenes else range(
        len(gltf.get("nodes", []))
    )
    nodes = gltf.get("nodes", [])

    def rec(i: int, parent: np.ndarray):
        node = nodes[i]
        world = parent @ _node_local(node)
        yield node, world
        for c in node.get("children", []):
            yield from rec(c, world)

    for r in roots:
        yield from rec(r, np.eye(4))


# -- materials ----------------------------------------------------------------

def _build_material(b: SceneBuilder, asset: _Asset, mat_idx: int,
                    cache: Dict[int, int]) -> int:
    if mat_idx in cache:
        return cache[mat_idx]
    gltf = asset.gltf
    mats = gltf.get("materials", [])
    if mat_idx < 0 or mat_idx >= len(mats):   # spec default material
        mid = b.principled((1.0, 1.0, 1.0), metallic=1.0, roughness=1.0)
        cache[mat_idx] = mid
        return mid
    m = mats[mat_idx]
    ext = m.get("extensions", {})

    def tex_image(tex_info, srgb: bool):
        if tex_info is None:
            return None
        tex = gltf["textures"][tex_info["index"]]
        src = tex.get("source")
        if src is None:
            return None
        if tex_info.get("texCoord", 0) != 0:
            return None   # only TEXCOORD_0 is sampled
        return asset.image(src, srgb)

    pbr = m.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", (1.0, 1.0, 1.0, 1.0))[:3]
    emissive = np.asarray(m.get("emissiveFactor", (0, 0, 0)), np.float64)
    strength = ext.get("KHR_materials_emissive_strength", {}).get(
        "emissiveStrength", 1.0
    )
    transmission = ext.get("KHR_materials_transmission", {}).get(
        "transmissionFactor", 0.0
    )

    if (emissive * strength).max() > 0.0:
        # Emitter: the tracer's material model is single-lobed, so a
        # material with emission becomes a light (the common authoring
        # intent for emissiveFactor > 0 at strength >= 1).
        mid = b.emissive(
            tuple(emissive * strength),
            texture=tex_image(m.get("emissiveTexture"), srgb=True),
        )
    elif transmission > 0.5:
        ior = ext.get("KHR_materials_ior", {}).get("ior", 1.5)
        mid = b.dielectric(
            ior=float(ior), tint=tuple(float(c) for c in base),
            roughness=float(pbr.get("roughnessFactor", 0.0))
            if pbr.get("roughnessFactor", 1.0) < 1.0 else 0.0,
        )
    else:
        cc = ext.get("KHR_materials_clearcoat", {})
        mid = b.principled(
            tuple(float(c) for c in base),
            metallic=float(pbr.get("metallicFactor", 1.0)),
            roughness=float(pbr.get("roughnessFactor", 1.0)),
            texture=tex_image(pbr.get("baseColorTexture"), srgb=True),
            mr_texture=tex_image(
                pbr.get("metallicRoughnessTexture"), srgb=False
            ),
            normal_map=tex_image(m.get("normalTexture"), srgb=False),
            clearcoat=float(cc.get("clearcoatFactor", 0.0)),
            clearcoat_roughness=float(
                cc.get("clearcoatRoughnessFactor", 0.1)
            ),
        )
    cache[mat_idx] = mid
    return mid


# -- geometry -----------------------------------------------------------------

def _primitive_arrays(asset: _Asset, prim: dict):
    mode = prim.get("mode", 4)
    if mode != 4:
        raise ValueError(f"only TRIANGLES primitives supported (mode {mode})")
    attrs = prim["attributes"]
    pos = asset.accessor(attrs["POSITION"]).astype(np.float64)
    if "indices" in prim:
        faces = asset.accessor(prim["indices"]).reshape(-1, 3).astype(
            np.int64
        )
    else:
        faces = np.arange(pos.shape[0], dtype=np.int64).reshape(-1, 3)
    uvs = None
    if "TEXCOORD_0" in attrs:
        uvs = asset.accessor(attrs["TEXCOORD_0"]).astype(np.float64)
    norms = None
    if "NORMAL" in attrs:
        norms = asset.accessor(attrs["NORMAL"]).astype(np.float64)
    return pos, faces, uvs, norms


def _apply_affine(world: np.ndarray, pos: np.ndarray,
                  norms: Optional[np.ndarray]):
    p = pos @ world[:3, :3].T + world[:3, 3]
    n = None
    if norms is not None:
        # Normals transform by the inverse-transpose of the linear part.
        lin = world[:3, :3]
        n = norms @ np.linalg.inv(lin)   # == (inv(lin).T @ n.T).T
        ln = np.linalg.norm(n, axis=1, keepdims=True)
        n = n / np.maximum(ln, 1e-20)
    return p, n


# -- punctual lights ----------------------------------------------------------

def _add_punctual(b: SceneBuilder, light: dict, world: np.ndarray) -> None:
    color = np.asarray(light.get("color", (1, 1, 1)), np.float64)
    intensity = float(light.get("intensity", 1.0))
    pos = world[:3, 3]
    direction = -world[:3, 2]   # lights point down the node's local -Z
    dn = np.linalg.norm(direction)
    direction = direction / (dn if dn > 0 else 1.0)
    t = light["type"]
    if t == "point":
        b.point_light(pos, tuple(color * intensity))
    elif t == "spot":
        spot = light.get("spot", {})
        outer = np.degrees(spot.get("outerConeAngle", np.pi / 4))
        inner = np.degrees(spot.get("innerConeAngle", 0.0))
        b.spot_light(pos, direction, tuple(color * intensity),
                     inner_degrees=min(inner, outer), outer_degrees=outer)
    elif t == "directional":
        b.directional_light(direction, tuple(color * intensity))


# -- camera -------------------------------------------------------------------

def _camera_from_node(gltf: dict, node: dict,
                      world: np.ndarray) -> Optional[CameraConfig]:
    cam = gltf.get("cameras", [])[node["camera"]]
    if cam.get("type") != "perspective":
        return None
    pos = world[:3, 3]
    fwd = -world[:3, 2]
    up = world[:3, 1]
    yfov = float(cam.get("perspective", {}).get("yfov", np.radians(60)))
    return CameraConfig(
        position=tuple(float(v) for v in pos),
        look_at=tuple(float(v) for v in pos + fwd),
        up=tuple(float(v) for v in up),
        vfov_degrees=float(np.degrees(yfov)),
    )


def _auto_camera(all_pos: List[np.ndarray]) -> CameraConfig:
    """No camera in the asset: frame the world-space bounding box from
    +Z with a 40° lens (the scene fills ~80% of the vertical FOV)."""
    pts = np.concatenate(all_pos, axis=0) if all_pos else np.zeros((1, 3))
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    center = (lo + hi) / 2
    radius = float(np.linalg.norm(hi - lo)) / 2 or 1.0
    dist = radius / np.tan(np.radians(20.0)) * 1.1
    return CameraConfig(
        position=tuple(center + np.array([0.0, 0.0, dist + radius])),
        look_at=tuple(center), vfov_degrees=40.0,
    )


# -- entry --------------------------------------------------------------------

def load_gltf(path: str, device=None) -> Tuple[Scene, CameraConfig]:
    """Load a .gltf / .glb file into a Scene built on ``device`` (the card
    unless the caller asks for another device) and a CameraConfig."""
    gltf, bin_chunk = _read_container(path)
    base_dir = os.path.dirname(os.path.abspath(path))
    asset = _Asset(gltf, _load_buffers(gltf, bin_chunk, base_dir), base_dir)

    b = SceneBuilder()
    mat_cache: Dict[int, int] = {}
    camera: Optional[CameraConfig] = None
    all_pos: List[np.ndarray] = []

    # Pass 1: group primitive uses by (mesh, prim) for instancing.
    uses: Dict[Tuple[int, int], List[np.ndarray]] = {}
    light_nodes: List[Tuple[dict, np.ndarray]] = []
    for node, world in _walk_nodes(gltf):
        if "camera" in node and camera is None:
            camera = _camera_from_node(gltf, node, world)
        lidx = node.get("extensions", {}).get(
            "KHR_lights_punctual", {}
        ).get("light")
        if lidx is not None:
            lights = gltf.get("extensions", {}).get(
                "KHR_lights_punctual", {}
            ).get("lights", [])
            if 0 <= lidx < len(lights):
                light_nodes.append((lights[lidx], world))
        if "mesh" in node:
            mesh = gltf["meshes"][node["mesh"]]
            for pi in range(len(mesh["primitives"])):
                uses.setdefault((node["mesh"], pi), []).append(world)

    # Pass 2: emit geometry.
    for (mesh_idx, pi), worlds in uses.items():
        prim = gltf["meshes"][mesh_idx]["primitives"][pi]
        pos, faces, uvs, norms = _primitive_arrays(asset, prim)
        mid = _build_material(b, asset, prim.get("material", -1), mat_cache)
        # TRUE instancing pays off when the prototype is shared and needs
        # no per-vertex attributes (the instanced kernels carry geometry
        # only); attributed primitives expand per use.
        plain = uvs is None and norms is None
        if len(worlds) > 1 and plain:
            b.add_instances(
                pos, faces, mid, [w[:3, :4] for w in worlds]
            )
            for w in worlds:
                all_pos.append(pos @ w[:3, :3].T + w[:3, 3])
        else:
            for w in worlds:
                p, n = _apply_affine(w, pos, norms)
                all_pos.append(p)
                b.add_mesh(
                    p, faces, mid,
                    uvs=uvs, uv_faces=faces if uvs is not None else None,
                    normals=n,
                    normal_faces=faces if n is not None else None,
                    smooth=n is not None,
                )

    for light, world in light_nodes:
        _add_punctual(b, light, world)

    if camera is None:
        camera = _auto_camera(all_pos)
    return b.build(device), camera
