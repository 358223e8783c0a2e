"""Cluster-packed triangle tables (the JAX package's ``ops/clusters.py``,
host build only).

Triangles are packed into clusters of up to 128 by the binned-SAH builder
with a 128-prim leaf size; each triangle is stored as a Woop unit-triangle
affine transform M = [e1 | e2 | n]^-1, b = -M v0, so a ray (o, d) hits
where w(t) = (M o + b + t M d).z crosses 0 with barycentrics read straight
off the transformed point. Per cluster the tensor has shape (4, 3*128):
column k holds [M_row; b_comp] for triangle k, grouped u | v | w.
Degenerate padding slots use M = 0, b = (-1, -1, 1): u = -1, never a hit.

The tables are byte-equal to the JAX package's numpy build (same code,
same numpy). The cluster tree, octant links, candidate blocks and HBM
pages that only the TPU tree and paged kernels read are not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from pathtracing_tpu_torch.ops import bvh as bvh_ops

CLUSTER_SIZE = 128  # triangles per cluster


class ClusterSet(NamedTuple):
    """Cluster tables (leading dim C = clusters), numpy on the host or
    tensors on a device.

    aabb_min/aabb_max: (C, 3) f32 cluster bounds.
    woop:   (C, 4, 3*128) f32 — [M | b] columns, grouped u | v | w.
    normal: (C, 3, 128) f32 — unit geometric normal per slot.
    mat:    (C, 128) i32 — material id per slot (0 for padding).
    """

    aabb_min: np.ndarray
    aabb_max: np.ndarray
    woop: np.ndarray
    normal: np.ndarray
    mat: np.ndarray


def build_clusters(
    v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, tri_mat: np.ndarray
) -> Tuple[ClusterSet, np.ndarray, np.ndarray]:
    """Pack triangles into SAH clusters; returns (ClusterSet-as-numpy,
    perm, slot_to_tri).

    ``perm`` maps new (cluster-contiguous, unpadded) order to input order;
    the padded global slot id of a hit is ``cluster*128 + lane`` and maps
    back to the INPUT triangle index through the (C*128,) i32
    ``slot_to_tri`` array (-1 for padding slots, which have mat 0 and
    never hit). Surface-attribute lookups (UVs, shading normals) resolve
    hits through it.
    """
    n = v0.shape[0]
    (node_min, node_max, node_meta), perm = bvh_ops.build_bvh(
        v0, e1, e2, leaf_size=CLUSTER_SIZE
    )
    v0p, e1p, e2p = v0[perm], e1[perm], e2[perm]
    matp = tri_mat[perm]

    # Leaves of the coarse BVH are the clusters (contiguous prim ranges).
    leaves = node_meta[node_meta[:, 2] > 0]
    order = np.argsort(leaves[:, 1], kind="stable")
    leaves = leaves[order]
    c = leaves.shape[0]

    aabb_min = np.empty((c, 3), np.float32)
    aabb_max = np.empty((c, 3), np.float32)
    woop = np.zeros((c, 4, 3 * CLUSTER_SIZE), np.float32)
    normal = np.zeros((c, 3, CLUSTER_SIZE), np.float32)
    mat = np.zeros((c, CLUSTER_SIZE), np.int32)

    # Fully vectorized packing (a per-leaf Python loop measured ~7 s at
    # 655k tris): every (cluster, lane) slot maps to a triangle index
    # via starts + lane; invalid/degenerate slots keep the always-miss
    # Woop pattern M = 0, b = (-1, -1, 1) → u = -1.
    ksz = CLUSTER_SIZE
    starts = leaves[:, 1].astype(np.int64)
    counts = leaves[:, 2].astype(np.int64)
    lane = np.arange(ksz)
    valid = lane[None, :] < counts[:, None]          # (C, 128)
    tri = np.minimum(starts[:, None] + lane[None, :], n - 1)
    tv0 = v0p[tri].astype(np.float64)                # (C, 128, 3)
    te1 = e1p[tri].astype(np.float64)
    te2 = e2p[tri].astype(np.float64)

    big = 3.0e38
    verts = np.stack([tv0, tv0 + te1, tv0 + te2], axis=2)  # (C,128,3,3)
    vmask = valid[:, :, None, None]
    aabb_min[:] = np.where(vmask, verts, big).min(axis=(1, 2))
    aabb_max[:] = np.where(vmask, verts, -big).max(axis=(1, 2))

    n_geo = np.cross(te1, te2)                       # (C, 128, 3)
    norm = np.linalg.norm(n_geo, axis=-1, keepdims=True)
    ok = norm[..., 0] > 1e-20
    n_unit = np.where(ok[..., None], n_geo / np.maximum(norm, 1e-20), 0.0)

    # M = [e1 | e2 | n]^-1 per triangle (n unnormalized keeps M finite
    # for thin tris); b = -M v0. Singular/degenerate slots become
    # padding (identity basis, always-miss b).
    basis = np.stack([te1, te2, n_geo], axis=-1)     # (C, 128, 3, 3)
    dets = np.linalg.det(basis)
    dead = (np.abs(dets) < 1e-30) | ~ok | ~valid
    basis[dead] = np.eye(3)
    m = np.linalg.inv(basis).astype(np.float32)      # (C, 128, 3, 3)
    b = -np.einsum("ckij,ckj->cki", m,
                   tv0.astype(np.float32))           # (C, 128, 3)
    miss_b = np.array([-1.0, -1.0, 1.0], np.float32)
    for comp in range(3):  # u, v, w rows of M
        colsl = slice(comp * ksz, (comp + 1) * ksz)
        woop[:, 0:3, colsl] = np.where(
            dead[:, None, :], 0.0, np.swapaxes(m[:, :, comp, :], 1, 2)
        )
        woop[:, 3, colsl] = np.where(dead, miss_b[comp], b[:, :, comp])
    normal[:] = np.where(
        dead[:, None, :], 0.0,
        np.swapaxes(n_unit, 1, 2).astype(np.float32),
    )
    mat[:] = np.where(dead | ~valid, 0, matp[tri])
    slot_to_tri = np.where(valid, perm[tri], -1).astype(np.int32).ravel()

    return (
        ClusterSet(aabb_min=aabb_min, aabb_max=aabb_max, woop=woop,
                   normal=normal, mat=mat),
        perm,
        slot_to_tri,
    )
