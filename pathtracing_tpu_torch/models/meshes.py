"""Mesh helpers (the JAX package's ``models/meshes.py``, as far as the
builders need them): area-weighted smooth vertex normals. The OBJ and PLY
loaders and the fit/transform helpers are not ported yet (ROADMAP queue A
item 18)."""

from __future__ import annotations

import numpy as np


def smooth_vertex_normals(vertices: np.ndarray,
                          faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (V, 3) in float64: each face's
    unnormalized cross product (∝ area) accumulates at its three corners
    (``np.add.at``), then each sum is normalized."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    acc = np.zeros_like(v)
    for c in range(3):
        np.add.at(acc, f[:, c], fn)
    norm = np.linalg.norm(acc, axis=1, keepdims=True)
    return acc / np.maximum(norm, 1e-20)
