"""Binned-SAH BVH (the JAX package's ``ops/bvh``): the host builders,
copied so the port stands alone, and the threaded traversal of the
``traversal="bvh"`` route.

``SceneBuilder.build`` builds it at leaf size 4: the stored triangle order
(which the light table follows, so light picks match the JAX package's)
and the scene's ``FlatBVH``. ``ops.clusters.build_clusters`` builds it at
leaf size 128 for the cluster packing. Nodes are in DFS preorder with
skip links, so a walk needs one node index per ray and no stack.

``build_bvh`` takes the C++ builder (``ops.bvh_native``, built at first
use) unless ``USE_NATIVE`` is False; it raises if that library cannot be
built. ``_build_bvh_numpy`` is the reference: the parity tests set
``USE_NATIVE = False`` where they hold the port against the JAX package's
NumPy build.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pathtracing_tpu_torch.ops import bvh_native, intersect

LEAF_SIZE = 4
SAH_BINS = 16
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.5
# Build with the C++ builder (False: the NumPy reference).
USE_NATIVE = True


class FlatBVH(NamedTuple):
    """The threaded BVH of a scene's triangles.

    node_min/node_max: (M, 3) f32 boxes; node_meta: (M, 3) i32
    [skip_link, prim_start, prim_count], prim_count 0 for an interior
    node; a skip link of M ends the walk."""

    node_min: torch.Tensor
    node_max: torch.Tensor
    node_meta: torch.Tensor


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
              leaf_size: int = LEAF_SIZE):
    """Threaded BVH over triangles (v0, v0+e1, v0+e2). Returns
    ((node_min, node_max, node_meta), permutation) where ``permutation``
    reorders the input triangles so each leaf covers a contiguous range."""
    if USE_NATIVE:
        return bvh_native.build(v0, e1, e2, leaf_size, SAH_BINS)
    return _build_bvh_numpy(v0, e1, e2, leaf_size)


def _build_bvh_numpy(v0, e1, e2, leaf_size=LEAF_SIZE):
    n = v0.shape[0]
    verts = np.stack([v0, v0 + e1, v0 + e2], axis=1)  # (n, 3, 3)
    prim_min = verts.min(axis=1).astype(np.float32)
    prim_max = verts.max(axis=1).astype(np.float32)
    centroid = (prim_min + prim_max) * 0.5

    # Worst case 2n-1 nodes for leaf size 1; leaf size 4 needs fewer but
    # allocate the bound and trim.
    max_nodes = max(2 * n, 1)
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    node_meta = np.empty((max_nodes, 3), np.int32)
    perm = np.arange(n, dtype=np.int64)

    node_count = 0
    # Explicit stack of (first, count) ranges into ``perm``; preorder
    # emission makes hit-links implicit (i+1).
    # Each stack entry also remembers the index of the parent slot whose
    # skip link must be patched once the subtree size is known — we instead
    # patch skips in a second pass from subtree extents.
    subtree_end = np.empty(max_nodes, np.int32)  # exclusive node index

    def emit(first, count):
        nonlocal node_count
        my = node_count
        node_count += 1
        idx = perm[first : first + count]
        node_min[my] = prim_min[idx].min(axis=0)
        node_max[my] = prim_max[idx].max(axis=0)

        if count <= leaf_size:
            node_meta[my] = (0, first, count)  # skip patched below
            subtree_end[my] = node_count
            return my

        idx_c = centroid[idx]
        ext = idx_c.max(axis=0) - idx_c.min(axis=0)
        axis = int(np.argmax(ext))

        split = None
        if ext[axis] > 1e-12:
            # Binned SAH along the widest centroid axis.
            lo = idx_c[:, axis].min()
            scale = SAH_BINS * (1.0 - 1e-6) / ext[axis]
            bins = np.minimum(
                ((idx_c[:, axis] - lo) * scale).astype(np.int32), SAH_BINS - 1
            )
            counts = np.bincount(bins, minlength=SAH_BINS)
            bmin = np.full((SAH_BINS, 3), np.inf, np.float32)
            bmax = np.full((SAH_BINS, 3), -np.inf, np.float32)
            for b in range(SAH_BINS):
                sel = bins == b
                if counts[b]:
                    bmin[b] = prim_min[idx[sel]].min(axis=0)
                    bmax[b] = prim_max[idx[sel]].max(axis=0)

            def area(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

            lmin = np.minimum.accumulate(bmin, axis=0)
            lmax = np.maximum.accumulate(bmax, axis=0)
            rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
            lcount = np.cumsum(counts)
            rcount = count - lcount
            cost = np.full(SAH_BINS - 1, np.inf)
            for b in range(SAH_BINS - 1):
                if lcount[b] and rcount[b]:
                    cost[b] = INTERSECT_COST * (
                        lcount[b] * area(lmin[b], lmax[b])
                        + rcount[b] * area(rmin[b + 1], rmax[b + 1])
                    )
            best = int(np.argmin(cost))
            if np.isfinite(cost[best]):
                left_sel = bins <= best
                split = int(left_sel.sum())
                order = np.argsort(~left_sel, kind="stable")
                perm[first : first + count] = idx[order]

        if split is None or split == 0 or split == count:
            # Degenerate centroids: median split keeps the tree balanced.
            order = np.argsort(idx_c[:, axis], kind="stable")
            perm[first : first + count] = idx[order]
            split = count // 2

        node_meta[my] = (0, 0, 0)  # interior
        emit(first, split)
        emit(first + split, count - split)
        subtree_end[my] = node_count
        return my

    if n == 0:
        # Single empty leaf so traversal code never special-cases T == 0.
        node_min[0] = np.zeros(3, np.float32)
        node_max[0] = np.zeros(3, np.float32)
        node_meta[0] = (1, 0, 0)
        node_count = 1
        subtree_end[0] = 1
    else:
        import sys

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 100_000))
        try:
            emit(0, n)
        finally:
            sys.setrecursionlimit(old)
        # Patch skip links: node i's miss-successor is the end of its subtree.
        node_meta[:node_count, 0] = subtree_end[:node_count]

    flat = (
        node_min[:node_count].copy(),
        node_max[:node_count].copy(),
        node_meta[:node_count].copy(),
    )
    return flat, perm


def traverse(bvh: FlatBVH, tri_v0, tri_e1, tri_e2, origin, direction,
             t_max):
    """Closest hit of a (R, 3) ray batch over the threaded BVH, in plain
    torch: (t (R,), prim (R,) i32), t = ``t_max`` and prim = -1 where no
    triangle is nearer.

    Each iteration takes one walk step for every unfinished ray (node
    index < M): the slab test against the ray's best t, the leaf's
    triangles tested in index order with the strict ``t < best`` rule,
    then the hit link (i + 1) into an interior node whose box was hit or
    the skip link otherwise. That is the JAX package's per-ray walk, so
    ``(t, prim)`` equal the vmapped JAX walk's. The loop runs until the
    ray with the longest walk finishes; finished rays leave the working
    set."""
    n_nodes = bvh.node_meta.shape[0]
    last = tri_v0.shape[0] - 1
    tiny = torch.where(direction >= 0, 1e-12, -1e-12)
    inv_d = 1.0 / torch.where(torch.abs(direction) < 1e-12, tiny, direction)
    r = origin.shape[0]
    dev = origin.device
    best_t = t_max.clone()
    best_prim = torch.full((r,), -1, dtype=torch.int32, device=dev)
    idx = torch.zeros(r, dtype=torch.int64, device=dev)
    rays = torch.arange(r, device=dev)
    o, d, iv = origin, direction, inv_d
    while rays.numel():
        bt, bp = best_t[rays], best_prim[rays]
        meta = bvh.node_meta[idx]
        skip, start, count = meta[:, 0], meta[:, 1], meta[:, 2]
        box_hit, _ = intersect.ray_aabb(o, iv, bvh.node_min[idx],
                                        bvh.node_max[idx], bt)
        is_leaf = count > 0
        test = is_leaf & box_hit
        for j in range(LEAF_SIZE):
            pid = torch.clamp(start + j, max=last).long()
            t = intersect.ray_triangle(o, d, tri_v0[pid], tri_e1[pid],
                                       tri_e2[pid], t_max=bt)
            ok = (j < count) & test & (t < bt)
            bt = torch.where(ok, t, bt)
            bp = torch.where(ok, pid.to(torch.int32), bp)
        best_t[rays], best_prim[rays] = bt, bp
        idx = torch.where(box_hit & ~is_leaf, idx + 1, skip.long())
        going = idx < n_nodes
        rays, idx = rays[going], idx[going]
        o, d, iv = o[going], d[going], iv[going]
    return best_t, best_prim
