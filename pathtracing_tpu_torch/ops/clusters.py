"""Cluster-packed triangle tables (the JAX package's ``ops/clusters.py``,
host build only).

Triangles are packed into clusters of up to 128 by the binned-SAH builder
with a 128-prim leaf size; each triangle is stored as a Woop unit-triangle
affine transform M = [e1 | e2 | n]^-1, b = -M v0, so a ray (o, d) hits
where w(t) = (M o + b + t M d).z crosses 0 with barycentrics read straight
off the transformed point. Per cluster the tensor has shape (4, 3*128):
column k holds [M_row; b_comp] for triangle k, grouped u | v | w.
Degenerate padding slots use M = 0, b = (-1, -1, 1): u = -1, never a hit.

``expand_instances`` lays shared-geometry instances out as expanded
(instance, prototype cluster) rows over one prototype ``ClusterSet``.

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


class InstanceSet(NamedTuple):
    """Instance-expanded traversal metadata over a shared prototype
    ClusterSet (true shared-geometry instancing).

    The heavy tensors (Woop/mat, ~6 KB/cluster) stay PROTOTYPE-sized in
    object space; only cheap per-cluster metadata expands per instance
    (~72 B/cluster), so a forest of N copies costs N × 72 B/cluster of
    extra memory instead of N × the geometry. The instanced DNF kernel
    (``cluster_trace.trace_inst``) culls EXPANDED world-space
    AABBs per ray exactly as the flat kernel does — off-screen instances
    are never evaluated — and at eval time transforms the ray into the
    pierced cluster's object space (t is preserved: o' = L·o + tr,
    d' = L·d with L = A⁻¹ keeps the world parameterization exactly), so
    one shared Woop block serves every instance.

    cmap:     (Ce,) i32  expanded cluster -> prototype cluster index.
    xform:    (Ce, 12) f32 world->object transform per expanded cluster,
              row-major [L00..L22, tr0, tr1, tr2].
    aabb_min: (Ce, 3) f32 world-space bounds (conservatively widened for
              the f32 corner-transform rounding).
    aabb_max: (Ce, 3) f32.
    inst_id:  (Ce,) i32 instance index (diagnostics; attrs later).
    imat:     (Ce,) i32 per-instance MATERIAL OVERRIDE (-1 = keep the
              prototype's per-triangle mats) — None when no placement
              overrides.
    fw0/fw1:  (Ce, 12) f32 OBJECT→WORLD endpoint affines
              [A00..A22 row-major, t0..t2] for motion-blurred instances
              (shutter open / close) — None for static instance sets.
              The motion path lerps the FORWARD affine (every prototype
              point then travels a straight world-space segment, so the
              endpoint-corner union AABB is an exact bound) and inverts
              per ray at eval time; static rows simply carry fw0 == fw1.
    """

    cmap: np.ndarray
    xform: np.ndarray
    aabb_min: np.ndarray
    aabb_max: np.ndarray
    inst_id: np.ndarray
    imat: np.ndarray = None
    fw0: np.ndarray = None
    fw1: np.ndarray = None


def expand_instances(proto: ClusterSet, placements) -> InstanceSet:
    """Expand per-instance placements into an InstanceSet.

    ``placements``: sequence of (first_cluster, n_clusters, M[, imat[,
    M1]]) where M is the (3, 4) or (4, 4) OBJECT→WORLD affine transform
    of one instance over the prototype cluster range [first_cluster,
    first_cluster + n_clusters). Transforms may rotate, translate, and
    scale (uniform or not — normals go through L^T which is exact for
    any invertible A). Optional 4th element: a per-instance material-id
    override (-1/absent = keep the prototype's mats); the ``imat``
    column is attached only when some placement overrides. Optional 5th
    element: the SHUTTER-CLOSE transform M1 (same shape; None/absent =
    static) — any present M1 attaches the ``fw0``/``fw1`` endpoint
    columns and union world bounds (see the class docstring).
    """
    cmaps, xforms, mins, maxs, iids, imats = [], [], [], [], [], []
    fw0s, fw1s = [], []
    any_motion = any(len(p) > 4 and p[4] is not None for p in placements)

    def norm_affine(m):
        m = np.asarray(m, np.float64)
        if m.shape == (4, 4):
            m = m[:3]
        if m.shape != (3, 4):
            raise ValueError(
                f"instance transform must be (3,4) or (4,4); got {m.shape}"
            )
        return m

    def corner_bounds(ids, a, t):
        # Transform the 8 corners of each proto AABB (exact for affine).
        lo = proto.aabb_min[ids].astype(np.float64)
        hi = proto.aabb_max[ids].astype(np.float64)
        corners = np.stack([
            np.where(np.array(mask)[None, :], hi, lo)
            for mask in ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
                         (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))
        ], axis=1)                                    # (count, 8, 3)
        wc = corners @ a.T + t                        # (count, 8, 3)
        return wc.min(axis=1), wc.max(axis=1)

    for iid, placement in enumerate(placements):
        first, count, m = placement[:3]
        imats.append(np.full(
            count,
            placement[3] if len(placement) > 3 else -1,
            np.int32,
        ))
        m = norm_affine(m)
        a, t = m[:, :3], m[:, 3]
        li = np.linalg.inv(a)
        tr = -li @ t
        ids = np.arange(first, first + count)
        cmaps.append(ids.astype(np.int32))
        xf = np.concatenate([li.reshape(9), tr]).astype(np.float32)
        xforms.append(np.tile(xf, (count, 1)))
        wmin, wmax = corner_bounds(ids, a, t)
        if any_motion:
            m1 = (norm_affine(placement[4])
                  if len(placement) > 4 and placement[4] is not None
                  else m)
            if abs(np.linalg.det(m1[:, :3])) < 1e-12:
                raise ValueError("motion transform is singular")
            fw0 = np.concatenate(
                [a.reshape(9), t]
            ).astype(np.float32)
            fw1 = np.concatenate(
                [m1[:, :3].reshape(9), m1[:, 3]]
            ).astype(np.float32)
            fw0s.append(np.tile(fw0, (count, 1)))
            fw1s.append(np.tile(fw1, (count, 1)))
            # Forward-lerped motion: every prototype point travels a
            # straight world segment, so the union of the ENDPOINT
            # corner bounds is exact.
            w1min, w1max = corner_bounds(ids, m1[:, :3], m1[:, 3])
            wmin = np.minimum(wmin, w1min)
            wmax = np.maximum(wmax, w1max)
        margin = (wmax - wmin) * 1e-6 + 1e-30
        mins.append((wmin - margin).astype(np.float32))
        maxs.append((wmax + margin).astype(np.float32))
        iids.append(np.full(count, iid, np.int32))
    imat_all = np.concatenate(imats)
    return InstanceSet(
        cmap=np.concatenate(cmaps),
        xform=np.concatenate(xforms),
        aabb_min=np.concatenate(mins),
        aabb_max=np.concatenate(maxs),
        inst_id=np.concatenate(iids),
        imat=imat_all if (imat_all >= 0).any() else None,
        fw0=np.concatenate(fw0s) if any_motion else None,
        fw1=np.concatenate(fw1s) if any_motion else None,
    )
