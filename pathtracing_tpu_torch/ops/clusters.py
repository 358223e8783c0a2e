"""Cluster-packed triangle tables, the threaded cluster tree and HBM pages
(the JAX package's ``ops/clusters.py``, host build only).

Triangles are packed into clusters of up to 128 by the binned-SAH builder
with a 128-prim leaf size; each triangle is stored as a Woop unit-triangle
affine transform M = [e1 | e2 | n]^-1, b = -M v0, so a ray (o, d) hits
where w(t) = (M o + b + t M d).z crosses 0 with barycentrics read straight
off the transformed point. Per cluster the tensor has shape (4, 3*128):
column k holds [M_row; b_comp] for triangle k, grouped u | v | w.
Degenerate padding slots use M = 0, b = (-1, -1, 1): u = -1, never a hit.

``expand_instances`` lays shared-geometry instances out as expanded
(instance, prototype cluster) rows over one prototype ``ClusterSet``;
``build_instance_tree`` keeps them in two levels instead, a tree over the
placements' world boxes above each prototype's own cluster tree, so that
its size grows with placements plus prototype clusters, not with their
product.

Past the flat kernels' budget a scene walks a threaded binary tree over the
cluster boxes (``build_cluster_tree``) with one set of links per direction
octant (``build_octant_trees``), or is repacked into pages of up to
``PAGE_CLUSTERS`` clusters, each with its own tree (``build_pages``,
``PageSet``).

The tables are byte-equal to the JAX package's numpy build (same code,
same numpy). The TPU lookahead kernel's candidate blocks
(``build_candidate_blocks``, ``cand_box``) are not ported: they exist
because Mosaic has no per-lane gather, and no Hopper kernel reads them.
``PageSet.cand_box`` is always None.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from pathtracing_tpu_torch.ops import bvh as bvh_ops

CLUSTER_SIZE = 128  # triangles per cluster
# The JAX package pages a scene whose cluster tree has more nodes than this
# (its TPU lookahead kernel's candidate-block ceiling); the port pages under
# the same condition so both packages route a scene alike.
CAND_MAX_NODES = 16384
PAGE_CLUSTERS = 2048    # clusters per HBM page (12 MB of Woop data)


class ClusterSet(NamedTuple):
    """Cluster tables (leading dim C = clusters), numpy on the host or
    tensors on a device.

    aabb_min/aabb_max: (C, 3) f32 cluster bounds.
    woop:   (C, 4, 3*128) f32 — [M | b] columns, grouped u | v | w.
    normal: (C, 3, 128) f32 — unit geometric normal per slot.
    mat:    (C, 128) i32 — material id per slot (0 for padding).
    node_box:  (6, N) f32 — threaded cluster-tree AABBs (xyz min, xyz
               max). None where no tree was built.
    node_meta: (2, N) i32 — [skip_link, cluster_id]; cluster_id == -1 for
               interior nodes. Preorder: hit-successor is node+1, miss (or
               after a leaf) jumps to skip_link; index N terminates.
    oct_links: (2, 8, N) i32 — per-direction-octant threaded links over
               the same node ids: [0] = hit_next (the octant's near child
               first), [1] = miss_next (the continuation).
    """

    aabb_min: np.ndarray
    aabb_max: np.ndarray
    woop: np.ndarray
    normal: np.ndarray
    mat: np.ndarray
    node_box: np.ndarray = None
    node_meta: np.ndarray = None
    oct_links: np.ndarray = None


class PageSet(NamedTuple):
    """Per-page traversal structures of a paged scene. Clusters are
    renumbered page-contiguously (page g holds clusters [g*P, (g+1)*P) of
    the flat ClusterSet, P = page size, the real ones first and then
    padding clusters with inverted boxes and always-miss Woop data).

    node_box:  (G, 6, Np) f32 per-page threaded-tree AABBs (trees padded
               to the largest page's node count with inverted never-hit
               nodes whose links all point at the terminator Np).
    node_meta: (G, 2, Np) i32 [skip, PAGE-LOCAL cluster id].
    oct_links: (G, 16, Np) i32 per-octant hit/miss links (flattened 2x8).
    n_real:    (G,) i32 real clusters of each page (its tree's leaves);
               the port's own field, counted once when the pages are built.
    cand_box:  always None (the TPU lookahead kernel's candidate blocks
               are not ported).
    """

    node_box: np.ndarray
    node_meta: np.ndarray
    oct_links: np.ndarray
    n_real: np.ndarray
    cand_box: np.ndarray = None


def build_cluster_tree(aabb_min: np.ndarray, aabb_max: np.ndarray):
    """Threaded binary tree over cluster AABBs (SAH split over all three
    axes, leaf = one cluster).

    Returns (node_box (6, N) f32, node_meta (2, N) i32, child (N, 2) i32,
    axis (N,) i8, first_is_lower (N,) bool): the children in emission
    order, the split axis and whether the first-emitted child is the
    lower-centroid one feed ``build_octant_trees``.
    """
    c = aabb_min.shape[0]
    centroid = (aabb_min + aabb_max) * 0.5
    max_nodes = 2 * c - 1 if c else 1
    box = np.empty((max_nodes, 6), np.float32)
    meta = np.empty((max_nodes, 2), np.int32)
    child = np.full((max_nodes, 2), -1, np.int32)
    axis_arr = np.zeros(max_nodes, np.int8)
    first_lower = np.zeros(max_nodes, np.bool_)
    count = 0

    def area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    def emit(ids):
        nonlocal count
        my = count
        count += 1
        k = len(ids)
        if k == 1:
            box[my, :3] = aabb_min[ids[0]]
            box[my, 3:] = aabb_max[ids[0]]
            meta[my] = (count, ids[0])
            return my
        meta[my, 1] = -1
        if k == 2:
            # Every axis costs the two boxes' areas, so the first axis
            # wins: the pair in x-centroid order.
            s = ids[np.argsort(centroid[ids, 0], kind="stable")]
            lo, hi = aabb_min[s], aabb_max[s]
            axis, cut = 0, 1
            l_lo, l_hi, r_lo, r_hi = lo[0], hi[0], lo[1], hi[1]
            box[my, :3] = np.minimum(l_lo, r_lo)
            box[my, 3:] = np.maximum(l_hi, r_hi)
        else:
            # SAH sweep over all three axes at once: minimize
            # A_l·n_l + A_r·n_r using prefix/suffix box unions of each
            # axis's sorted order.
            order = np.argsort(centroid[ids], axis=0, kind="stable").T
            ss = ids[order]                                   # (3, k)
            lo, hi = aabb_min[ss], aabb_max[ss]               # (3, k, 3)
            pre_lo = np.minimum.accumulate(lo, axis=1)
            pre_hi = np.maximum.accumulate(hi, axis=1)
            suf_lo = np.minimum.accumulate(lo[:, ::-1], axis=1)[:, ::-1]
            suf_hi = np.maximum.accumulate(hi[:, ::-1], axis=1)[:, ::-1]

            def sa(lo_, hi_):
                d = np.maximum(hi_ - lo_, 0.0)
                return (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                        + d[..., 2] * d[..., 0])

            n_l = np.arange(1, k)
            cost = (sa(pre_lo[:, :-1], pre_hi[:, :-1]) * n_l
                    + sa(suf_lo[:, 1:], suf_hi[:, 1:]) * (k - n_l))
            js = np.argmin(cost, axis=1)
            best, axis = np.inf, None
            for ax in range(3):
                if cost[ax, js[ax]] < best:
                    best, axis = cost[ax, js[ax]], ax
            j = int(js[axis])
            s, cut = ss[axis], j + 1
            l_lo, l_hi = pre_lo[axis, j], pre_hi[axis, j]
            r_lo, r_hi = suf_lo[axis, cut], suf_hi[axis, cut]
            box[my, :3] = pre_lo[0, -1]
            box[my, 3:] = pre_hi[0, -1]
        # ``left`` is the lower-centroid side along the winning axis by
        # construction — build_octant_trees relies on that.
        left, right = s[:cut], s[cut:]
        # Emit the larger-area child first (the order of the unordered
        # walk; the octant links order children by direction instead).
        lower_first = area(l_lo, l_hi) >= area(r_lo, r_hi)
        if not lower_first:
            left, right = right, left
        child[my, 0] = emit(left)
        child[my, 1] = emit(right)
        axis_arr[my] = axis
        first_lower[my] = lower_first
        meta[my, 0] = count  # skip = end of subtree
        return my

    if c == 0:
        box[0] = 0.0
        meta[0] = (1, -1)
        count = 1
    else:
        import sys

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 100_000))
        try:
            emit(np.arange(c))
        finally:
            sys.setrecursionlimit(old)

    return (box[:count].T.copy(), meta[:count].T.copy(), child[:count],
            axis_arr[:count], first_lower[:count])


def build_octant_trees(child: np.ndarray, axis: np.ndarray,
                       first_lower: np.ndarray) -> np.ndarray:
    """Per-direction-octant threaded links: (2, 8, N) i32.

    ``[0, o, n]`` = hit_next (descend into the octant's NEAR child — the
    lower-coordinate child along the node's split axis when the octant's
    direction is positive on that axis, else the upper), ``[1, o, n]`` =
    miss_next (the continuation after skipping or finishing ``n``'s
    subtree); a leaf's two links are both its continuation. All eight
    orderings share node ids; index N terminates. A ray that follows its
    own octant's links walks the tree front to back, so its first leaf
    hits tighten best_t and the slab test's ``tn < best_t`` culls the
    subtrees behind them.
    """
    n = child.shape[0]
    # Octant bit layout: x>0 → +4, y>0 → +2, z>0 → +1 (a zero component
    # counts as negative).
    pos = (np.arange(8)[:, None] >> np.array([2, 1, 0])) & 1     # (8, 3)
    lower = np.where(first_lower, child[:, 0], child[:, 1])
    upper = np.where(first_lower, child[:, 1], child[:, 0])
    toward = pos[:, axis.astype(np.int64)].astype(bool)           # (8, N)
    near = np.where(toward, lower, upper)
    far = np.where(toward, upper, lower)
    # Each node's continuation, a level at a time from the root's (N):
    # the near child continues at the far one, the far child at its
    # parent's continuation.
    cont = np.empty((8, n), np.int32)
    cont[:, 0] = n
    octs = np.arange(8)[:, None]
    level = np.array([0])
    while level.size:
        level = level[child[level, 0] >= 0]
        cont[octs, near[:, level]] = far[:, level]
        cont[octs, far[:, level]] = cont[:, level]
        level = child[level].ravel()
    inner = child[:, 0] >= 0
    return np.stack([np.where(inner, near, cont), cont]).astype(np.int32)


def partition_pages(aabb_min: np.ndarray, aabb_max: np.ndarray,
                    page_size: int):
    """Spatial median partition of clusters into lists of <= page_size
    ids (recursion order keeps pages spatially coherent)."""
    centroid = (aabb_min + aabb_max) * 0.5
    pages = []
    stack = [np.arange(aabb_min.shape[0])]
    while stack:
        ids = stack.pop()
        if len(ids) <= page_size:
            pages.append(ids)
            continue
        ext = centroid[ids].max(axis=0) - centroid[ids].min(axis=0)
        ax = int(np.argmax(ext))
        order = np.argsort(centroid[ids, ax], kind="stable")
        # Cut at a page_size multiple near the median, so every page but
        # possibly the last is full.
        half_pages = max(1, round(len(ids) / 2 / page_size))
        cut = min(half_pages * page_size, len(ids) - 1)
        stack.append(ids[order[cut:]])
        stack.append(ids[order[:cut]])
    return pages


def with_tree(cs: ClusterSet) -> ClusterSet:
    """``cs`` (numpy) with its threaded cluster tree: as it is when it
    carries one, else with one built over its real clusters (padding
    clusters' inverted boxes stay out of it), leaf ids in the set's own
    numbering. The flat kernels walk it."""
    if cs.node_box is not None:
        return cs
    real = np.nonzero((cs.aabb_min <= cs.aabb_max).all(axis=1))[0]
    nb, nm, child, axis, flo = build_cluster_tree(cs.aabb_min[real],
                                                  cs.aabb_max[real])
    ol = build_octant_trees(child, axis, flo)
    nm[1] = np.where(nm[1] >= 0, real[np.maximum(nm[1], 0)], -1)
    return cs._replace(node_box=nb, node_meta=nm, oct_links=ol)


def build_pages(cs: ClusterSet, page_size: int = PAGE_CLUSTERS):
    """Repack a ClusterSet page-contiguously and build per-page trees.

    Returns (flat ClusterSet in page order, padded to G*page_size clusters
    — slot ids shift accordingly —, the PageSet, and ``remap``: old
    cluster id → new). Padding clusters get inverted boxes (min 3e38, max
    -3e38, which a slab test passes for every ray) and always-miss Woop
    data, and appear in no tree. The flat set's global tree is that of
    ``cs`` (built over the real clusters when ``cs`` has none) with its
    cluster ids renumbered to the page order, so the tree kernels keep
    working on the same object.
    """
    pages = partition_pages(cs.aabb_min, cs.aabb_max, page_size)
    g = len(pages)
    c_pad = g * page_size

    def pad_rows(arr, miss_fill):
        out = np.empty((c_pad,) + arr.shape[1:], arr.dtype)
        out[:] = miss_fill
        for p, ids in enumerate(pages):
            out[p * page_size: p * page_size + len(ids)] = arr[ids]
        return out

    aabb_min = pad_rows(cs.aabb_min, 3.0e38)
    aabb_max = pad_rows(cs.aabb_max, -3.0e38)
    woop = np.zeros((c_pad, 4, 3 * CLUSTER_SIZE), np.float32)
    # Degenerate always-miss Woop pattern for padding clusters.
    woop[:, 3, 0 * CLUSTER_SIZE: 1 * CLUSTER_SIZE] = -1.0
    woop[:, 3, 1 * CLUSTER_SIZE: 2 * CLUSTER_SIZE] = -1.0
    woop[:, 3, 2 * CLUSTER_SIZE: 3 * CLUSTER_SIZE] = 1.0
    normal = np.zeros((c_pad, 3, CLUSTER_SIZE), np.float32)
    mat = np.zeros((c_pad, CLUSTER_SIZE), np.int32)
    for p, ids in enumerate(pages):
        sl = slice(p * page_size, p * page_size + len(ids))
        woop[sl] = cs.woop[ids]
        normal[sl] = cs.normal[ids]
        mat[sl] = cs.mat[ids]

    # Per-page trees over the REAL clusters (page-local ids 0..len-1).
    boxes, metas, links_l = [], [], []
    np_max = max(2 * max(len(ids) for ids in pages) - 1, 1)
    for ids in pages:
        nb, nm, child, axis, flo = build_cluster_tree(
            cs.aabb_min[ids], cs.aabb_max[ids]
        )
        ol = build_octant_trees(child, axis, flo)
        n = nb.shape[1]
        pad = np_max - n
        if pad:
            nb_pad = np.empty((6, pad), np.float32)
            nb_pad[0:3] = 3.0e38
            nb_pad[3:6] = -3.0e38
            nb = np.concatenate([nb, nb_pad], axis=1)
            nm_pad = np.empty((2, pad), np.int32)
            nm_pad[0] = np_max
            nm_pad[1] = -1
            nm = np.concatenate([nm, nm_pad], axis=1)
            ol = np.concatenate(
                [ol, np.full((2, 8, pad), np_max, np.int32)], axis=2
            )
        # Real links that pointed at the page terminator (n) must point
        # past the padded tree too; any id >= n terminates at np_max.
        nm[0] = np.where(nm[0] >= n, np_max, nm[0])
        ol = np.where(ol >= n, np_max, ol)
        boxes.append(nb)
        metas.append(nm)
        links_l.append(ol.reshape(16, np_max))

    tree = with_tree(cs)
    nb, nm, ol = tree.node_box, tree.node_meta, tree.oct_links
    # Renumber the global tree's cluster ids to the page order.
    remap = np.full(cs.aabb_min.shape[0], -1, np.int64)
    for p, ids in enumerate(pages):
        remap[ids] = p * page_size + np.arange(len(ids))
    cid = nm[1]
    nm = nm.copy()
    nm[1] = np.where(cid >= 0, remap[np.maximum(cid, 0)], -1)
    flat = ClusterSet(
        aabb_min=aabb_min, aabb_max=aabb_max, woop=woop, normal=normal,
        mat=mat, node_box=nb, node_meta=nm, oct_links=ol,
    )
    pageset = PageSet(
        node_box=np.stack(boxes),
        node_meta=np.stack(metas),
        oct_links=np.stack(links_l),
        n_real=np.array([len(ids) for ids in pages], np.int32),
    )
    return flat, pageset, remap


def remap_slot_to_tri(slot_to_tri: np.ndarray, remap: np.ndarray,
                      c_pad: int) -> np.ndarray:
    """Reindex a (C*128,) slot → triangle map after ``build_pages``
    renumbered the clusters page-contiguously (``remap``: old cluster id →
    new); every slot of a padding cluster maps to -1 (it never hits)."""
    rows = slot_to_tri.reshape(-1, CLUSTER_SIZE)
    out = np.full((c_pad, CLUSTER_SIZE), -1, np.int32)
    out[remap] = rows
    return out.ravel()


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

    node_box, node_meta, child, axis, first_lower = build_cluster_tree(
        aabb_min, aabb_max
    )
    oct_links = build_octant_trees(child, axis, first_lower)
    return (
        ClusterSet(aabb_min=aabb_min, aabb_max=aabb_max, woop=woop,
                   normal=normal, mat=mat, node_box=node_box,
                   node_meta=node_meta, oct_links=oct_links),
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
    inst_first: (P+1,) i32 placement runs: placement p (the base geometry,
              or one instance) owns expanded clusters [inst_first[p],
              inst_first[p+1]), in index order.
    inst_min/inst_max: (P, 3) f32 each placement's box, the union of its
              expanded boxes; the closest-hit kernel culls whole
              placements with it. The port's own fields
              (``placement_boxes``), counted once when the set is built.
    """

    cmap: np.ndarray
    xform: np.ndarray
    aabb_min: np.ndarray
    aabb_max: np.ndarray
    inst_id: np.ndarray
    imat: np.ndarray = None
    fw0: np.ndarray = None
    fw1: np.ndarray = None
    inst_first: np.ndarray = None
    inst_min: np.ndarray = None
    inst_max: np.ndarray = None


def placement_boxes(inst_id: np.ndarray, aabb_min: np.ndarray,
                    aabb_max: np.ndarray):
    """(inst_first (P+1,) i32, inst_min (P, 3) f32, inst_max (P, 3) f32) of
    an instance set: the maximal runs of equal ``inst_id`` (one per
    placement, as ``expand_instances`` emits them) and the union of each
    run's expanded boxes."""
    inst_id = np.asarray(inst_id)
    starts = np.flatnonzero(np.diff(inst_id) != 0) + 1
    first = np.concatenate([[0], starts, [inst_id.shape[0]]]).astype(np.int32)
    if inst_id.shape[0] == 0:
        empty = np.zeros((0, 3), np.float32)
        return first[:1], empty, empty.copy()
    lo = np.minimum.reduceat(np.asarray(aabb_min, np.float32), first[:-1])
    hi = np.maximum.reduceat(np.asarray(aabb_max, np.float32), first[:-1])
    return first, lo, hi


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
    aabb_min, aabb_max = np.concatenate(mins), np.concatenate(maxs)
    inst_id = np.concatenate(iids)
    inst_first, inst_min, inst_max = placement_boxes(inst_id, aabb_min,
                                                     aabb_max)
    return InstanceSet(
        cmap=np.concatenate(cmaps),
        xform=np.concatenate(xforms),
        aabb_min=aabb_min,
        aabb_max=aabb_max,
        inst_id=inst_id,
        imat=imat_all if (imat_all >= 0).any() else None,
        fw0=np.concatenate(fw0s) if any_motion else None,
        fw1=np.concatenate(fw1s) if any_motion else None,
        inst_first=inst_first, inst_min=inst_min, inst_max=inst_max,
    )


class InstanceTree(NamedTuple):
    """Two-level shared-geometry instancing: one record per placement
    under a threaded tree over the placements' world boxes, above a forest
    of the prototypes' own object-space cluster trees. Nothing grows with
    placements × prototype clusters.

    Placement p (the base geometry, as an identity placement, is p = 0):

    xform:    (P, 12) f32 world->object transform [L00..L22 row-major,
              tr0, tr1, tr2], inverted in float64 as ``expand_instances``
              inverts it.
    root:     (P,) i32 root node of its prototype's tree in the forest.
    imat:     (P,) i32 material override (-1 keeps the prototype's) —
              None when no placement overrides.
    aabb_min/aabb_max: (P, 3) f32 world box: the corners of its
              prototype's root box transformed in float64, widened as
              ``expand_instances`` widens an expanded box.

    The top tree over those boxes (leaf id = placement):

    node_box (6, N) f32, node_meta (2, N) i32, oct_links (2, 8, N) i32,
    as ``build_cluster_tree`` / ``build_octant_trees`` give them.

    The forest: every prototype's cluster tree (the base geometry's
    first) stacked, in its prototype's OBJECT space:

    forest_box (6, F) f32, forest_meta (2, F) i32, forest_links (2, 8, F)
    i32. Node ids and links are global; every tree's links end at F. Each
    leaf holds its cluster's id in the combined ClusterSet (the
    prototype's cluster offset added), so the walk below a placement's
    root reads its leaves as a flat tree's.
    """

    xform: np.ndarray
    root: np.ndarray
    imat: np.ndarray
    aabb_min: np.ndarray
    aabb_max: np.ndarray
    node_box: np.ndarray
    node_meta: np.ndarray
    oct_links: np.ndarray
    forest_box: np.ndarray
    forest_meta: np.ndarray
    forest_links: np.ndarray


def _stack_forest(trees):
    """One forest of ``trees`` = [(first cluster, ClusterSet with its tree
    over its own clusters)]: (forest_box, forest_meta, forest_links, roots
    (K,) i32)."""
    total = sum(cs.node_box.shape[1] for _, cs in trees)
    boxes, metas, links, roots = [], [], [], []
    off = 0
    for first, cs in trees:
        n = cs.node_box.shape[1]

        def glob(ids):
            # Local node ids move by the offset; the tree's end, n, ends
            # the forest.
            return np.where(ids >= n, total, ids + off).astype(np.int32)

        meta = np.stack([glob(cs.node_meta[0]),
                         np.where(cs.node_meta[1] >= 0,
                                  cs.node_meta[1] + first, -1)])
        boxes.append(cs.node_box)
        metas.append(meta.astype(np.int32))
        links.append(glob(cs.oct_links))
        roots.append(off)
        off += n
    return (np.concatenate(boxes, axis=1), np.concatenate(metas, axis=1),
            np.concatenate(links, axis=2), np.array(roots, np.int32))


def build_instance_tree(trees, placements) -> InstanceTree:
    """The two-level structure of ``placements`` over ``trees``.

    ``trees``: [(first cluster, ClusterSet)] per prototype, in the
    combined ClusterSet's order, each set carrying its tree over its own
    clusters (``build_clusters``' tree; the base geometry's first).
    ``placements``: [(prototype index, M, imat)] with M the (3, 4) or
    (4, 4) OBJECT->WORLD affine and imat the material override (-1
    keeps the prototype's); the base geometry is one identity placement
    of prototype 0."""
    forest_box, forest_meta, forest_links, roots = _stack_forest(trees)
    p = len(placements)
    m = np.stack([np.asarray(pl[1], np.float64)[:3] for pl in placements])
    a, t = m[:, :, :3], m[:, :, 3]
    li = np.linalg.inv(a)
    # The translation placement by placement, in ``expand_instances``'
    # expression.
    tr = np.stack([-li[i] @ t[i] for i in range(p)])
    xform = np.concatenate([li.reshape(p, 9), tr], axis=1).astype(np.float32)
    root = roots[np.array([pl[0] for pl in placements], np.int64)]
    imat = np.array([pl[2] for pl in placements], np.int32)
    # The 8 corners of each prototype's root box as masks over (min, max),
    # taken to world space.
    masks = np.array([[(k >> 2) & 1, (k >> 1) & 1, k & 1]
                      for k in range(8)], bool)
    box = forest_box[:, root].T.astype(np.float64)              # (P, 6)
    corners = np.where(masks, box[:, None, 3:], box[:, None, :3])
    corners = corners @ a.transpose(0, 2, 1) + t[:, None, :]    # (P, 8, 3)
    wmin, wmax = corners.min(axis=1), corners.max(axis=1)
    margin = (wmax - wmin) * 1e-6 + 1e-30
    lo = (wmin - margin).astype(np.float32)
    hi = (wmax + margin).astype(np.float32)
    nb, nm, child, axis, flo = build_cluster_tree(lo, hi)
    return InstanceTree(
        xform=xform, root=root, imat=imat if (imat >= 0).any() else None,
        aabb_min=lo, aabb_max=hi, node_box=nb, node_meta=nm,
        oct_links=build_octant_trees(child, axis, flo),
        forest_box=forest_box, forest_meta=forest_meta,
        forest_links=forest_links)
