"""Mesh I/O and helpers (the JAX package's ``models/meshes.py``, host
numpy): Wavefront OBJ and Stanford PLY loading (fan-triangulated
polygons, negative OBJ indices, optional texture coordinates and
normals), an OBJ writer, area-weighted smooth vertex normals, and the
fit/transform placement helpers."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file -> (vertices (V,3) f64, faces (F,3) i64).

    Polygons are fan-triangulated; indices may be negative (relative) per
    the OBJ spec. Normals/texcoords are dropped here — use
    ``load_obj_full`` to keep them; materials come from the scene
    description, not .mtl files.
    """
    verts, faces, *_ = load_obj_full(path)
    return verts, faces


def load_obj_full(path: str):
    """Parse an OBJ file keeping surface attributes.

    Returns (vertices (V,3) f64, faces (F,3) i64, uvs (U,2) f64 | None,
    uv_faces (F,3) i64 | None, normals (M,3) f64 | None,
    normal_faces (F,3) i64 | None). The attribute index buffers are None
    unless EVERY face corner carries that attribute (partially-attributed
    OBJs degrade to geometry-only, matching ``SceneBuilder.add_mesh``'s
    all-or-nothing per-chunk contract).
    """
    verts, uvs, norms = [], [], []
    faces, uvf, nrf = [], [], []
    uv_ok = nr_ok = True

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
            elif line.startswith("f "):
                vi, ti, ni = [], [], []
                for token in line.split()[1:]:
                    comps = token.split("/")
                    vi.append(resolve(comps[0], len(verts)))
                    ti.append(resolve(comps[1], len(uvs))
                              if len(comps) > 1 else None)
                    ni.append(resolve(comps[2], len(norms))
                              if len(comps) > 2 else None)
                for k in range(1, len(vi) - 1):  # fan triangulation
                    faces.append((vi[0], vi[k], vi[k + 1]))
                    if ti[0] is None or ti[k] is None or ti[k + 1] is None:
                        uv_ok = False
                    else:
                        uvf.append((ti[0], ti[k], ti[k + 1]))
                    if ni[0] is None or ni[k] is None or ni[k + 1] is None:
                        nr_ok = False
                    else:
                        nrf.append((ni[0], ni[k], ni[k + 1]))
    if not verts or not faces:
        raise ValueError(f"OBJ file {path!r} has no triangles")
    has_uv = uv_ok and uvs and len(uvf) == len(faces)
    has_nr = nr_ok and norms and len(nrf) == len(faces)
    return (
        np.asarray(verts, np.float64),
        np.asarray(faces, np.int64),
        np.asarray(uvs, np.float64) if has_uv else None,
        np.asarray(uvf, np.int64) if has_uv else None,
        np.asarray(norms, np.float64) if has_nr else None,
        np.asarray(nrf, np.int64) if has_nr else None,
    )


def smooth_vertex_normals(vertices: np.ndarray,
                          faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (V, 3): each face's unnormalized
    cross product (∝ area) accumulates at its three corners — the
    standard smooth-shading normals for meshes that ship without them."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    acc = np.zeros_like(v)
    for c in range(3):
        np.add.at(acc, f[:, c], fn)
    norm = np.linalg.norm(acc, axis=1, keepdims=True)
    return acc / np.maximum(norm, 1e-20)


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Write a minimal OBJ (round-trip partner of ``load_obj``)."""
    with open(path, "w") as f:
        for v in np.asarray(vertices, np.float64):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for a, b, c in np.asarray(faces, np.int64) + 1:
            f.write(f"f {a} {b} {c}\n")


def fit_to_box(vertices: np.ndarray, center, size: float) -> np.ndarray:
    """Uniformly scale + translate a mesh so its bounding box is centered
    at ``center`` with the longest side equal to ``size``."""
    v = np.asarray(vertices, np.float64)
    lo, hi = v.min(axis=0), v.max(axis=0)
    extent = (hi - lo).max()
    if extent <= 0:
        raise ValueError("degenerate mesh: zero bounding box")
    scale = size / extent
    mid = (lo + hi) * 0.5
    return (v - mid) * scale + np.asarray(center, np.float64)


def transform(vertices: np.ndarray, scale=1.0, rotate_y_degrees=0.0,
              translate=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Scale -> rotate about +y -> translate (the common placement combo)."""
    v = np.asarray(vertices, np.float64) * float(scale)
    th = np.radians(rotate_y_degrees)
    c, s = np.cos(th), np.sin(th)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)
    return v @ rot.T + np.asarray(translate, np.float64)


_PLY_TYPES = {
    "char": ("i1", 1), "int8": ("i1", 1),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "short": ("i2", 2), "int16": ("i2", 2),
    "ushort": ("u2", 2), "uint16": ("u2", 2),
    "int": ("i4", 4), "int32": ("i4", 4),
    "uint": ("u4", 4), "uint32": ("u4", 4),
    "float": ("f4", 4), "float32": ("f4", 4),
    "double": ("f8", 8), "float64": ("f8", 8),
}


def load_ply(path: str):
    """Parse a PLY file (Stanford polygon format) — the other standard
    scanned-asset container (bunny/dragon/buddha ship as .ply).

    Supports ascii 1.0 and binary_little_endian 1.0, vertex properties
    x/y/z (+ optional nx/ny/nz normals and u/v | s/t texcoords), and a
    face vertex_indices list (fan-triangulated). Same return contract
    as ``load_obj_full``: (vertices, faces, uvs, uv_faces, normals,
    normal_faces) — PLY attributes are per-vertex, so the attribute
    index buffers equal ``faces`` when present.
    """
    with open(path, "rb") as f:
        data = f.read()

    # ---- header ----
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    body = data[end:]
    if header[0].strip() != "ply":
        raise ValueError(f"{path!r} is not a PLY file")
    fmt = None
    elements = []  # (name, count, [(prop_name, type, list_index_type?)])
    for line in header[1:]:
        parts = line.split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], parts[3], parts[2]))
            else:
                elements[-1][2].append((parts[2], parts[1], None))
    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"unsupported PLY format {fmt!r} in {path!r}")

    verts = norms = uvs = None
    faces = []
    if fmt == "ascii":
        tokens = body.decode("ascii").split("\n")
        rows = [t.split() for t in tokens if t.strip()]
        at = 0
        for name, count, props in elements:
            if name == "vertex":
                cols = [p for p, _, lt in props if lt is None]
                arr = np.asarray(
                    [r[:len(cols)] for r in rows[at:at + count]],
                    np.float64,
                )
                vdict = {c: arr[:, i] for i, c in enumerate(cols)}
                verts, norms, uvs = _ply_vertex_attrs(vdict)
            elif name == "face":
                for r in rows[at:at + count]:
                    n = int(r[0])
                    idx = [int(x) for x in r[1:1 + n]]
                    for k in range(1, n - 1):
                        faces.append((idx[0], idx[k], idx[k + 1]))
            at += count
    else:
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                if any(lt is not None for _, _, lt in props):
                    raise ValueError("list property on PLY vertices")
                dt = np.dtype([(p, "<" + _PLY_TYPES[t][0])
                               for p, t, _ in props])
                arr = np.frombuffer(body, dt, count, off)
                off += dt.itemsize * count
                vdict = {p: arr[p].astype(np.float64)
                         for p, _, _ in props}
                verts, norms, uvs = _ply_vertex_attrs(vdict)
            elif name == "face":
                for _ in range(count):
                    (pname, etype, ltype) = props[0]
                    lsz = _PLY_TYPES[ltype][1]
                    esz = _PLY_TYPES[etype][1]
                    n = int(np.frombuffer(
                        body, "<" + _PLY_TYPES[ltype][0], 1, off)[0])
                    off += lsz
                    idx = np.frombuffer(
                        body, "<" + _PLY_TYPES[etype][0], n, off
                    ).astype(np.int64)
                    off += esz * n
                    for k in range(1, n - 1):
                        faces.append((idx[0], idx[k], idx[k + 1]))
                    # Trailing non-list face properties are not
                    # supported (rare); keep the parser honest.
                    if len(props) > 1:
                        raise ValueError(
                            "extra PLY face properties unsupported"
                        )
            else:
                if fmt == "binary_little_endian":
                    raise ValueError(
                        f"unknown binary PLY element {name!r}"
                    )

    if verts is None or not faces:
        raise ValueError(f"PLY file {path!r} has no triangles")
    faces_np = np.asarray(faces, np.int64)
    return (
        verts, faces_np,
        uvs, faces_np if uvs is not None else None,
        norms, faces_np if norms is not None else None,
    )


def _ply_vertex_attrs(vdict):
    """Split a PLY vertex property dict into (verts, normals, uvs)."""
    verts = np.stack([vdict["x"], vdict["y"], vdict["z"]], axis=1)
    norms = None
    if all(k in vdict for k in ("nx", "ny", "nz")):
        norms = np.stack([vdict["nx"], vdict["ny"], vdict["nz"]], axis=1)
    uvs = None
    for ku, kv in (("u", "v"), ("s", "t")):
        if ku in vdict and kv in vdict:
            uvs = np.stack([vdict[ku], vdict[kv]], axis=1)
            break
    return verts, norms, uvs
