"""Cluster-sweep closest-hit and any-hit traversal: CUDA kernels for Hopper
plus their plain torch versions.

One contract, as in the JAX package's ``ops/cluster_trace.py``:

  trace(clusters, origin, direction, t_init) -> (t, slot, normal, mat)

``t_init`` is the per-ray closest hit found so far (e.g. from the sphere
set; 0 marks a dead lane), ``t`` improves on it or passes it through,
``slot = cluster*128 + lane`` (-1 = no triangle hit), and on a miss
``normal = 0`` and ``mat = 0``.

  occluded(clusters, origin, direction, t_max) -> (R,) bool

True where some triangle lies strictly inside (T_MIN, t_max); ``t_max <=
0`` marks a dead lane.

``trace`` and ``occluded`` dispatch on the tensors' device: a CPU tensor
takes the plain version, a CUDA tensor launches the hand-written kernel in
``csrc/cluster_trace.cu`` or raises. Each launch adds one to ``LAUNCHES``.
``trace`` walks the flat set's cluster tree (``ClusterSet.node_box``,
``node_meta``, ``oct_links``; plain version ``trace_flat_walk_torch``, the
kernel's visiting order, normal and material from the tables);
``trace_torch``, a torch port of the JAX package's ``trace_jax`` index-order
sweep, is the oracle it is held to: t bit for bit, slot equal or t tied.
``occluded`` walks the same tree with the cap fixed (plain version
``occluded_tree_torch``; a set without a tree raises, as for ``trace``);
``occluded_torch``, the JAX package's index-order sweep, is its oracle.
Occlusion does not depend on the order of visits, so the two are equal.

Instanced scenes (``ops.clusters.InstanceSet``) go through

  trace_inst(clusters, inst, origin, direction, t_init, time=None)
  occluded_inst(clusters, inst, origin, direction, t_max, time=None)

with the same contract over expanded (instance, prototype cluster) world
boxes: ``slot`` is a PROTOTYPE slot, ``normal`` is in world space, ``mat``
carries the per-instance override, and ``time`` is the per-ray shutter time
of a motion-blurred set (mid-shutter when None; ignored by static sets).
Plain versions ``trace_inst_torch`` / ``occluded_inst_torch`` (a port of
``trace_jax_inst``); kernels in ``csrc/cluster_trace_inst.cu``. Both
kernels cull whole placements by ``InstanceSet.inst_min`` / ``inst_max``
first, exactly, so the index-order sweeps stay their plain versions.

Static placements whose expansion would pass ``DNF_MAX_CLUSTERS`` stay in
two levels (``ops.clusters.InstanceTree``) and go through

  trace_inst_tree(clusters, itree, origin, direction, t_init)
  occluded_inst_tree(clusters, itree, origin, direction, t_max)

with the contract of the instanced pair (``slot`` a slot of the combined
ClusterSet, ``normal`` in world space, ``mat`` with the placement's
override): each ray walks a tree over the placements' world boxes and, in
each placement it enters, the prototype's cluster tree in object space.
Plain versions ``trace_inst_tree_torch`` / ``occluded_inst_tree_torch``
(the kernels' order); kernels in ``csrc/cluster_trace_inst_tree.cu``, on
the shared walker. Against ``trace_inst_torch`` over the same placements
expanded: t bit for bit, slot, normal and material equal or t tied; the
any hit equal.

Scenes past ``DNF_MAX_CLUSTERS`` (``ops.clusters`` trees and pages) go
through

  trace_paged_dnf(clusters, pages, origin, direction, t_init)
  occluded_paged_dnf(clusters, pages, origin, direction, t_max)
  trace_tree(clusters, origin, direction, t_init)
  occluded_tree(clusters, origin, direction, t_max)
  trace_tree_paged(clusters, pages, origin, direction, t_init)

with the same contract, ``slot`` in the page-ordered cluster numbering of
a paged set. All five walk threaded cluster trees per ray, each ray along
its own direction octant's links (plain versions: vectorised walks in
which all live rays step together). ``trace_paged_dnf``,
``occluded_paged_dnf`` and ``trace_tree_paged`` walk each page's tree, a
ray's pages nearest first (plain versions ``trace_paged_walk_torch``,
whose normal and material come from the cluster tables,
``occluded_paged_dnf_torch`` and ``trace_tree_paged_walk_torch``; kernels
in ``csrc/cluster_trace_paged.cu`` and ``csrc/cluster_trace_tree.cu``).
``trace_paged_dnf_torch`` is the JAX package's order: pages in index
order, each page's real clusters in index order, equal to ``trace_torch``
over the padded set; the walk gives its t bit for bit and its slot or a
tied t. Likewise ``trace_tree_paged_torch``, each page's tree walked in
page order, is the index-order oracle of ``trace_tree_paged``.
``trace_tree`` and ``occluded_tree`` walk the whole tree
(``trace_tree_torch``, ``occluded_tree_torch``; kernels in
``csrc/cluster_trace_tree.cu``). The normal of ``trace_tree`` and
``trace_tree_paged`` is the winner's Woop w-row normalised, as in the JAX
tree kernels.
"""

from __future__ import annotations

import ctypes

import torch

from pathtracing_tpu_torch.ops import cuda_build
from pathtracing_tpu_torch.ops.clusters import CLUSTER_SIZE
from pathtracing_tpu_torch.ops.intersect import T_MIN

_BIG = 3.0e38
# Cluster-count ceiling of the JAX package's flat DNF kernels: a scene past
# it is paged by SceneBuilder, or (unpaged) walks the cluster tree.
DNF_MAX_CLUSTERS = 8192

# Launch counts of the CUDA kernels (a run resets them to 0 before the
# path it wants to account for and reads them after).
LAUNCHES = {"trace": 0, "occluded": 0, "trace_inst": 0,
            "occluded_inst": 0, "trace_paged_dnf": 0,
            "occluded_paged_dnf": 0, "trace_tree": 0, "occluded_tree": 0,
            "trace_tree_paged": 0, "trace_inst_tree": 0,
            "occluded_inst_tree": 0}


# What the two-level walks count where a caller gives them ``counts``
# (the engine's traced frames): placement leaves a ray pierced and walked,
# and prototype leaves it evaluated, in this order.
WALK_COUNTS = ("placements_entered", "proto_clusters_tested")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --- plain torch versions ----------------------------------------------


def _safe_inv(d3):
    tiny = torch.where(d3 >= 0, 1e-12, -1e-12)
    return 1.0 / torch.where(torch.abs(d3) < 1e-12, tiny, d3)


def _slab(origin, inv_d, bmin, bmax, best_t):
    """Rays × one AABB slab test (the JAX ``_slab6``); ``bmin``/``bmax``
    index by axis to a scalar, or to an (R,) column of per-ray boxes.
    Returns (R,) bool."""
    tn = torch.full_like(best_t, -_BIG)
    tf = torch.full_like(best_t, _BIG)
    for ax in range(3):
        o = origin[:, ax]
        iv = inv_d[:, ax]
        t0 = (bmin[ax] - o) * iv
        t1 = (bmax[ax] - o) * iv
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    return (tn <= tf) & (tf > T_MIN) & (tn < best_t)


def _pair_eval(origin, direction, woop_c, best_t):
    """Rays × one cluster's 128 Woop triangles (the JAX ``_pair_eval``):
    broadcast multiply-adds in a fixed order, no matmul. ``woop_c`` is one
    cluster's (4, 384) tensor, or (n, 4, 384) with each ray's own cluster;
    ``best_t`` is (n, 1). Returns t (n, 128) with misses at _BIG."""
    w = [woop_c[..., row, :] for row in range(4)]
    op = w[3] + origin[:, 0:1] * w[0]
    op = op + origin[:, 1:2] * w[1]
    op = op + origin[:, 2:3] * w[2]
    dp = direction[:, 0:1] * w[0]
    dp = dp + direction[:, 1:2] * w[1]
    dp = dp + direction[:, 2:3] * w[2]
    k = CLUSTER_SIZE
    op_u, op_v, op_w = op[:, :k], op[:, k:2 * k], op[:, 2 * k:]
    dp_u, dp_v, dp_w = dp[:, :k], dp[:, k:2 * k], dp[:, 2 * k:]
    dw = torch.where(torch.abs(dp_w) < 1e-30, 1e-30, dp_w)
    t = -op_w / dw
    u = op_u + t * dp_u
    v = op_v + t * dp_v
    ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > T_MIN) & (t < best_t))
    return torch.where(ok, t, _BIG)


def lookup_hit(clusters, slot):
    """(normal (R, 3), mat (R,)) of padded slot ids; slot -1 reads slot 0
    (callers mask misses)."""
    safe = torch.clamp(slot, min=0).long()
    c_idx = safe // CLUSTER_SIZE
    lane = safe % CLUSTER_SIZE
    return clusters.normal[c_idx, :, lane], clusters.mat[c_idx, lane]


def _closest_update(t_pair, c, bt, best_t, best_slot, idx):
    """Fold one evaluation into the closest hit of rays ``idx``: ``t_pair``
    (n, 128) from ``_pair_eval`` capped at their best t ``bt`` (n,), ``c``
    the evaluated cluster id (scalar or (n,)). Strict ``<`` across
    clusters and the smallest lane on a tie within one (the JAX
    ``trace_jax`` tie rule)."""
    lane = torch.arange(CLUSTER_SIZE, dtype=torch.int32, device=bt.device)
    t_min = torch.min(t_pair, dim=1).values
    slot = torch.min(
        torch.where(t_pair <= t_min[:, None], lane, CLUSTER_SIZE), dim=1
    ).values
    upd = t_min < bt
    best_t[idx] = torch.where(upd, t_min, bt)
    best_slot[idx] = torch.where(upd, c * CLUSTER_SIZE + slot,
                                 best_slot[idx]).to(torch.int32)


class _Counts:
    """Work counters of a plain traversal: slab tests and cluster
    evaluations, into ``stats`` when given."""

    def __init__(self, stats=None):
        self.stats = stats
        self.slab_tests = self.cluster_evals = 0

    def add(self, tested, evaluated):
        """``tested``: the number of rays slab-tested (a count or a
        0-d tensor); ``evaluated``: the indices of the rays evaluated
        against a cluster."""
        if self.stats is not None:
            self.slab_tests += int(tested)
            self.cluster_evals += evaluated.numel()

    def record(self):
        if self.stats is not None:
            self.stats["slab_tests"] = self.slab_tests
            self.stats["cluster_evals"] = self.cluster_evals


def _sweep(clusters, cluster_ids, origin, direction, inv_d, best_t,
           best_slot, counts, want=None):
    """Closest-hit sweep of ``cluster_ids`` in order (in place on
    ``best_t``/``best_slot``); only live rays (and, given ``want``, only
    those rays) whose slab test passes are evaluated against a cluster —
    elementwise the same arithmetic, so the result equals the fully masked
    sweep. ``counts`` (``_Counts``) accumulates."""
    for c in cluster_ids:
        live = best_t > 0.0
        if want is not None:
            live = live & want
        hit = live & _slab(origin, inv_d, clusters.aabb_min[c],
                           clusters.aabb_max[c], best_t)
        idx = torch.nonzero(hit).squeeze(1)
        counts.add(live.sum() if counts.stats is not None else 0, idx)
        if idx.numel() == 0:
            continue
        bt = best_t[idx]
        t_pair = _pair_eval(origin[idx], direction[idx], clusters.woop[c],
                            bt[:, None])
        _closest_update(t_pair, c, bt, best_t, best_slot, idx)


def _table_hit(clusters, best_t, best_slot):
    """The closest-hit result with normal and material from the tables."""
    normal, mat = lookup_hit(clusters, best_slot)
    miss = best_slot < 0
    normal = torch.where(miss[:, None], 0.0, normal)
    mat = torch.where(miss, 0, mat)
    return best_t, best_slot, normal, mat


def _start(origin, t_init):
    """(best_t, best_slot) before a closest-hit query."""
    return (t_init.to(torch.float32).clone(),
            torch.full((origin.shape[0],), -1, dtype=torch.int32,
                       device=origin.device))


def trace_torch(clusters, origin, direction, t_init, stats=None):
    """Plain closest-hit sweep: every cluster in index order, strict ``<``
    across clusters and the smallest lane on a tie within one (the JAX
    ``trace_jax`` order and tie rule). The oracle of every closest-hit
    kernel; the flat kernel's own plain version is
    ``trace_flat_walk_torch``. ``stats`` (optional dict) receives
    ``slab_tests`` and ``cluster_evals``: the (ray, cluster) pairs this
    input needs."""
    best_t, best_slot = _start(origin, t_init)
    counts = _Counts(stats)
    _sweep(clusters, range(clusters.woop.shape[0]), origin, direction,
           _safe_inv(direction), best_t, best_slot, counts)
    counts.record()
    return _table_hit(clusters, best_t, best_slot)


def occluded_torch(clusters, origin, direction, t_max, stats=None):
    """Plain any-hit sweep: equal to ``trace_torch(..., t_max)[1] >= 0``
    (the JAX package's any-hit oracle), with lanes retired once a hit is
    found. The oracle of the flat any hit, whose plain version is the walk
    ``occluded_tree_torch``. ``stats`` as in ``trace_torch``."""
    n_clusters = clusters.woop.shape[0]
    cap = t_max.to(torch.float32)
    occ = torch.zeros(origin.shape[0], dtype=torch.bool, device=origin.device)
    inv_d = _safe_inv(direction)
    n_slab = n_eval = 0
    for c in range(n_clusters):
        live = (cap > 0.0) & ~occ
        hit = live & _slab(origin, inv_d, clusters.aabb_min[c],
                           clusters.aabb_max[c], cap)
        idx = torch.nonzero(hit).squeeze(1)
        if stats is not None:
            n_slab += int(live.sum())
            n_eval += idx.numel()
        if idx.numel() == 0:
            continue
        t_pair = _pair_eval(origin[idx], direction[idx], clusters.woop[c],
                            cap[idx][:, None])
        occ[idx] = torch.min(t_pair, dim=1).values < cap[idx]
    if stats is not None:
        stats["slab_tests"] = n_slab
        stats["cluster_evals"] = n_eval
    return occ


# --- plain torch versions of the big-scene routes -----------------------


def page_shape(clusters, pages):
    """(pages G, clusters per page P, real clusters per page as an (G,)
    int32 tensor) of a paged scene: page g's real clusters are [g*P,
    g*P + n_real[g]), the leaves of its tree."""
    n_pages = pages.node_box.shape[0]
    return n_pages, clusters.woop.shape[0] // n_pages, pages.n_real


def trace_paged_dnf_torch(clusters, pages, origin, direction, t_init,
                          stats=None):
    """Plain paged closest-hit sweep: pages in order, each page's real
    clusters in index order. A ray whose slab test misses a page's bounds
    (the root box of its tree) sits the page out: it would miss every box
    in it, so the result equals ``trace_torch`` over the padded set bit for
    bit, while padding clusters (inverted boxes, which a slab test passes
    for every ray) are never evaluated. ``stats`` as in ``trace_torch``
    (the page tests count as slab tests)."""
    n_pages, page_size, n_real = page_shape(clusters, pages)
    best_t, best_slot = _start(origin, t_init)
    inv_d = _safe_inv(direction)
    counts = _Counts(stats)
    no_rays = torch.zeros(0, dtype=torch.int64, device=origin.device)
    for g, n in enumerate(n_real.tolist()):
        live = best_t > 0.0
        root = pages.node_box[g, :, 0]
        want = live & _slab(origin, inv_d, root[:3], root[3:], best_t)
        counts.add(live.sum() if stats is not None else 0, no_rays)
        if not bool(want.any()):
            continue
        c0 = g * page_size
        _sweep(clusters, range(c0, c0 + n), origin, direction, inv_d,
               best_t, best_slot, counts, want=want)
    counts.record()
    return _table_hit(clusters, best_t, best_slot)


def _octant(direction):
    """(R,) direction octant: x>0 → +4, y>0 → +2, z>0 → +1 (a zero
    component counts as negative), the layout of ``oct_links``."""
    return ((direction[:, 0] > 0).long() * 4 + (direction[:, 1] > 0).long()
            * 2 + (direction[:, 2] > 0).long())


def _walk_torch(tree, woop, origin, direction, inv_d, octant, best_t,
                best_slot, counts, page=None, page_size=0, want=None,
                occ=None):
    """Per-ray walk of threaded trees ``tree`` = (node_box (G, 6, N),
    node_meta (G, 2, N), links (G, 16, N)), all walking rays stepping
    together: each live ray (and, given ``want``, only those rays) walks
    tree ``page[ray]`` (default 0), gathers each node's box, slab-tests it
    against the ray's best t, evaluates the rays that stand on a pierced
    leaf against its cluster (page-local leaf id + page * ``page_size``),
    and moves to ``links[oct]`` (hit) or ``links[8 + oct]`` (miss) of its
    own octant until it passes the last node. Closest hit: in place on
    ``best_t`` / ``best_slot``. Any hit (``occ`` given): ``best_t`` is the
    fixed cap, and a ray is retired at its first hit (``occ`` set in
    place)."""
    node_box, node_meta, links = tree
    n_nodes = node_box.shape[2]
    live = best_t > 0.0
    if want is not None:
        live = live & want
    if occ is not None:
        live = live & ~occ
    if page is None:
        page = torch.zeros_like(live, dtype=torch.int64)
    node = torch.where(live, 0, n_nodes).long()
    while True:
        idx = torch.nonzero(node < n_nodes).squeeze(1)
        if idx.numel() == 0:
            break
        nd, pg = node[idx], page[idx]
        box = node_box[pg, :, nd].T                          # (6, n)
        bt = best_t[idx]
        hit = _slab(origin[idx], inv_d[idx], box[:3], box[3:], bt)
        cid = node_meta[pg, 1, nd]
        leaf = hit & (cid >= 0)
        li = idx[leaf]
        counts.add(idx.numel(), li)
        oc = octant[idx]
        nxt = torch.where(hit, links[pg, oc, nd], links[pg, 8 + oc, nd]).long()
        if li.numel():
            c = cid[leaf].long() + pg[leaf] * page_size
            t_pair = _pair_eval(origin[li], direction[li], woop[c],
                                bt[leaf][:, None])
            if occ is None:
                _closest_update(t_pair, c, bt[leaf], best_t, best_slot, li)
            else:
                found = torch.min(t_pair, dim=1).values < bt[leaf]
                occ[li] = found
                nxt[leaf] = torch.where(found, n_nodes, nxt[leaf])
        node[idx] = nxt


_TREE_FIELDS = ("node_box", "node_meta", "oct_links")


def _require_tree(clusters):
    missing = [f for f in _TREE_FIELDS if getattr(clusters, f) is None]
    if missing:
        raise ValueError("this ClusterSet carries no cluster tree (missing: "
                         + ", ".join(missing)
                         + "; ops.clusters.with_tree builds one)")


def _tree(clusters):
    _require_tree(clusters)
    n = clusters.node_box.shape[1]
    return (clusters.node_box[None], clusters.node_meta[None],
            clusters.oct_links.reshape(1, 16, n))


def _walk_closest(clusters, origin, direction, t_init, stats):
    """(best_t, best_slot) of the plain closest-hit walk of the set's
    cluster tree (see ``_walk_torch``)."""
    best_t, best_slot = _start(origin, t_init)
    counts = _Counts(stats)
    _walk_torch(_tree(clusters), clusters.woop, origin, direction,
                _safe_inv(direction), _octant(direction), best_t, best_slot,
                counts)
    counts.record()
    return best_t, best_slot


def _woop_normal_hit(clusters, best_t, best_slot):
    """The closest-hit result of the tree walks: normal = the winner's
    Woop w-row normalised with rsqrt (as the JAX tree kernels compute it),
    material from the table."""
    safe = torch.clamp(best_slot, min=0).long()
    c, lane = safe // CLUSTER_SIZE, safe % CLUSTER_SIZE
    w = clusters.woop[c, 0:3, 2 * CLUSTER_SIZE + lane]        # (R, 3)
    nx, ny, nz = w[:, 0], w[:, 1], w[:, 2]
    inv_len = torch.rsqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                      min=1e-30))
    normal = torch.stack([nx * inv_len, ny * inv_len, nz * inv_len], dim=1)
    miss = best_slot < 0
    normal = torch.where(miss[:, None], 0.0, normal)
    mat = torch.where(miss, 0, clusters.mat[c, lane])
    return best_t, best_slot, normal, mat


def trace_tree_torch(clusters, origin, direction, t_init, stats=None):
    """Plain per-ray cluster-tree walk, closest hit (see ``_walk_torch``):
    the clusters each ray reaches, in the kernel's order; the normal from
    the winner's Woop w-row. ``stats``: ``slab_tests`` (node visits) and
    ``cluster_evals``."""
    return _woop_normal_hit(clusters, *_walk_closest(
        clusters, origin, direction, t_init, stats))


def trace_flat_walk_torch(clusters, origin, direction, t_init, stats=None):
    """Plain closest hit of a flat set in its kernel's order: the walk of
    ``trace_tree_torch`` over the set's cluster tree, with normal and
    material from the cluster tables, as the JAX DNF kernel gives them.
    Against ``trace_torch`` (index order): t bit for bit, slot equal or t
    tied. ``stats`` as in ``trace_tree_torch``."""
    return _table_hit(clusters, *_walk_closest(
        clusters, origin, direction, t_init, stats))


def occluded_tree_torch(clusters, origin, direction, t_max, stats=None):
    """Plain per-ray cluster-tree walk, any hit: equal to
    ``trace_torch(..., t_max)[1] >= 0``, each ray retired at its first
    hit. The plain version of the flat any hit and of the tree route's.
    ``stats`` as in ``trace_tree_torch``."""
    cap = t_max.to(torch.float32)
    occ = torch.zeros(origin.shape[0], dtype=torch.bool, device=origin.device)
    counts = _Counts(stats)
    _walk_torch(_tree(clusters), clusters.woop, origin, direction,
                _safe_inv(direction), _octant(direction), cap, None, counts,
                occ=occ)
    counts.record()
    return occ


def trace_tree_paged_torch(clusters, pages, origin, direction, t_init,
                           stats=None):
    """Plain per-ray walk of each page's tree in page order, closest hit,
    the best t carried from page to page; page-local cluster ids become
    global slots ``(page*P + cid)*128 + lane``. The index-order oracle of
    ``trace_tree_paged`` (the JAX ``trace_pallas_paged``'s order), whose
    plain version is ``trace_tree_paged_walk_torch``. ``stats`` as in
    ``trace_tree_torch``."""
    n_pages, page_size, _ = page_shape(clusters, pages)
    best_t, best_slot = _start(origin, t_init)
    inv_d, octant = _safe_inv(direction), _octant(direction)
    counts = _Counts(stats)
    tree = (pages.node_box, pages.node_meta, pages.oct_links)
    for g in range(n_pages):
        _walk_torch(tree, clusters.woop, origin, direction, inv_d, octant,
                    best_t, best_slot, counts,
                    page=torch.full_like(octant, g), page_size=page_size)
    counts.record()
    return _woop_normal_hit(clusters, best_t, best_slot)


def _page_entry(pages, origin, inv_d):
    """(R, G) entry distance of each ray into each page's root box (column
    0 of its tree), ``_BIG`` where the ray misses the box: the kernel's
    ``page_entry``, in ``_slab``'s arithmetic, so entry < best t exactly
    where ``_slab`` passes."""
    root = pages.node_box[:, :, 0]                           # (G, 6)
    shape = (origin.shape[0], root.shape[0])
    tn = torch.full(shape, -_BIG, dtype=torch.float32, device=origin.device)
    tf = torch.full(shape, _BIG, dtype=torch.float32, device=origin.device)
    for ax in range(3):
        o = origin[:, ax:ax + 1]
        iv = inv_d[:, ax:ax + 1]
        t0 = (root[:, ax] - o) * iv
        t1 = (root[:, 3 + ax] - o) * iv
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    return torch.where((tn <= tf) & (tf > T_MIN), tn, _BIG)


def _walk_pages_closest(clusters, pages, origin, direction, t_init, stats):
    """(best_t, best_slot) of the plain paged closest-hit walk in the
    kernels' order: each ray walks its pages nearest first (by the entry
    distance into each page's root box, ties by page index) and stops at
    the first page it enters no earlier than its best t; each page's tree
    is walked as in ``trace_tree_paged_torch``. Leaves are real clusters
    only, so padding clusters are never evaluated."""
    n_pages, page_size, _ = page_shape(clusters, pages)
    best_t, best_slot = _start(origin, t_init)
    inv_d, octant = _safe_inv(direction), _octant(direction)
    entry, order = torch.sort(_page_entry(pages, origin, inv_d), dim=1,
                              stable=True)
    tree = (pages.node_box, pages.node_meta, pages.oct_links)
    counts = _Counts(stats)
    for k in range(n_pages):
        want = (best_t > 0.0) & (entry[:, k] < best_t)
        if not bool(want.any()):
            break        # later pages start further: no ray enters them
        _walk_torch(tree, clusters.woop, origin, direction, inv_d, octant,
                    best_t, best_slot, counts, page=order[:, k],
                    page_size=page_size, want=want)
    counts.record()
    return best_t, best_slot


def trace_paged_walk_torch(clusters, pages, origin, direction, t_init,
                           stats=None):
    """Plain paged closest hit in the kernel's order (``_walk_pages_closest``)
    with the normal and material from the cluster tables. Against
    ``trace_paged_dnf_torch`` (index order): t bit for bit, slot equal or t
    tied. ``stats`` as in ``trace_tree_torch``."""
    return _table_hit(clusters, *_walk_pages_closest(
        clusters, pages, origin, direction, t_init, stats))


def trace_tree_paged_walk_torch(clusters, pages, origin, direction, t_init,
                                stats=None):
    """Plain per-page tree walk, closest hit, in its kernel's order: the
    walk of ``trace_paged_walk_torch`` (pages nearest first) with the
    normal from the winner's Woop w-row, as ``trace_tree_torch`` gives it.
    Against ``trace_tree_paged_torch`` (pages in index order): t bit for
    bit, slot equal or t tied. ``stats`` as in ``trace_tree_torch``."""
    return _woop_normal_hit(clusters, *_walk_pages_closest(
        clusters, pages, origin, direction, t_init, stats))


def occluded_paged_dnf_torch(clusters, pages, origin, direction, t_max,
                             stats=None):
    """Plain paged any hit: ``trace_paged_dnf_torch(..., t_max)[1] >= 0``,
    the JAX package's paged occlusion. The kernel visits the clusters in
    another order and stops early, but whether some triangle lies inside
    (T_MIN, t_max) does not depend on that. ``stats`` as there."""
    return trace_paged_dnf_torch(clusters, pages, origin, direction, t_max,
                                 stats=stats)[1] >= 0


# --- instanced plain torch versions --------------------------------------


def _lerp_affine_inverse(fw0, fw1, tt):
    """Per-ray world→object transform of a motion-blurred instance (the
    JAX ``_lerp_affine_inverse``). fw0/fw1: the 12 endpoint OBJECT→WORLD
    entries [A00..A22 row-major, t0..t2] as sequences of scalars or
    columns; tt: the shutter time. The forward affine is lerped
    (``f0 + tt·(f1 − f0)``, which gives f0's bits at tt = 0) and inverted
    by adjugate. Returns the 12 ``_ray_to_object`` entries. The formula
    order is the CUDA kernel's (``load_xform``)."""
    a = [f0 + tt * (f1 - f0) for f0, f1 in zip(fw0, fw1)]
    a00, a01, a02, a10, a11, a12, a20, a21, a22, t0, t1, t2 = a
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    inv = 1.0 / torch.where(torch.abs(det) < 1e-30,
                            torch.where(det < 0, -1e-30, 1e-30), det)
    l_ = [c00 * inv, c01 * inv, c02 * inv,
          c10 * inv, c11 * inv, c12 * inv,
          c20 * inv, c21 * inv, c22 * inv]
    tr0 = -(l_[0] * t0 + l_[1] * t1 + l_[2] * t2)
    tr1 = -(l_[3] * t0 + l_[4] * t1 + l_[5] * t2)
    tr2 = -(l_[6] * t0 + l_[7] * t1 + l_[8] * t2)
    return l_ + [tr0, tr1, tr2]


def _ray_to_object(xf, origin, direction):
    """Rays by 12 world→object entries [L00..L22 row-major, tr0..tr2] (the
    JAX ``_ray_to_object``). The order of the sums is load-bearing: the
    kernel uses the same, and an identity transform passes a ray through
    bit for bit (tr + 1·o + 0 + 0 = o). Returns (origin, direction) in
    object space, (n, 3) each."""
    o0, o1, o2 = origin[:, 0], origin[:, 1], origin[:, 2]
    d0, d1, d2 = direction[:, 0], direction[:, 1], direction[:, 2]
    o_e = torch.stack([
        xf[9] + xf[0] * o0 + xf[1] * o1 + xf[2] * o2,
        xf[10] + xf[3] * o0 + xf[4] * o1 + xf[5] * o2,
        xf[11] + xf[6] * o0 + xf[7] * o1 + xf[8] * o2,
    ], dim=1)
    d_e = torch.stack([
        xf[0] * d0 + xf[1] * d1 + xf[2] * d2,
        xf[3] * d0 + xf[4] * d1 + xf[5] * d2,
        xf[6] * d0 + xf[7] * d1 + xf[8] * d2,
    ], dim=1)
    return o_e, d_e


def _shutter_time(inst, time, r, device):
    """(r,) f32 per-ray shutter time of a motion set (mid-shutter when the
    caller gives none), or None for a static set."""
    if inst.fw0 is None:
        return None
    if time is None:
        return torch.full((r,), 0.5, dtype=torch.float32, device=device)
    return time.to(torch.float32)


def _object_rays(inst, e, origin, direction, tt):
    """Rays in the object space of expanded cluster ``e``."""
    if tt is None:
        cols = inst.xform[e].unbind(0)
    else:
        cols = _lerp_affine_inverse(inst.fw0[e].unbind(0),
                                    inst.fw1[e].unbind(0), tt)
    return _ray_to_object(cols, origin, direction)


def _no_hit(t_init):
    """The closest-hit result when nothing can be hit: t passed through,
    slot -1, normal 0, mat 0."""
    r, dev = t_init.shape[0], t_init.device
    return (t_init, torch.full((r,), -1, dtype=torch.int32, device=dev),
            torch.zeros((r, 3), dtype=torch.float32, device=dev),
            torch.zeros(r, dtype=torch.int32, device=dev))


def trace_inst_torch(clusters, inst, origin, direction, t_init, time=None,
                     stats=None):
    """Plain instanced closest-hit sweep (the JAX ``trace_jax_inst``): every
    expanded cluster in index order, strict ``<`` across them and the
    smallest lane on a tie within one; the winning expanded cluster
    ``best_e`` picks the transform of the world normal and the material
    override. Only the rays whose slab test passes are evaluated, as in
    ``trace_torch``. ``stats`` as there."""
    r = origin.shape[0]
    dev = origin.device
    ne = inst.cmap.shape[0]
    if ne == 0:
        return _no_hit(t_init)
    best_t = t_init.to(torch.float32).clone()
    best_slot = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_e = torch.zeros(r, dtype=torch.int64, device=dev)
    tt = _shutter_time(inst, time, r, dev)
    inv_d = _safe_inv(direction)
    lane = torch.arange(CLUSTER_SIZE, dtype=torch.int32, device=dev)
    cmap = inst.cmap.tolist()
    n_slab = n_eval = 0
    for e in range(ne):
        live = best_t > 0.0
        hit = live & _slab(origin, inv_d, inst.aabb_min[e],
                           inst.aabb_max[e], best_t)
        idx = torch.nonzero(hit).squeeze(1)
        if stats is not None:
            n_slab += int(live.sum())
            n_eval += idx.numel()
        if idx.numel() == 0:
            continue
        o_e, d_e = _object_rays(inst, e, origin[idx], direction[idx],
                                None if tt is None else tt[idx])
        bt = best_t[idx]
        p = cmap[e]
        t_pair = _pair_eval(o_e, d_e, clusters.woop[p], bt[:, None])
        t_min = torch.min(t_pair, dim=1).values
        slot = torch.min(
            torch.where(t_pair <= t_min[:, None], lane, CLUSTER_SIZE), dim=1
        ).values
        upd = t_min < bt
        best_t[idx] = torch.where(upd, t_min, bt)
        best_slot[idx] = torch.where(upd, p * CLUSTER_SIZE + slot,
                                     best_slot[idx])
        best_e[idx] = torch.where(upd, e, best_e[idx])
    if stats is not None:
        stats["slab_tests"] = n_slab
        stats["cluster_evals"] = n_eval
    if tt is None:
        xf = inst.xform[best_e].unbind(1)
    else:
        xf = _lerp_affine_inverse(inst.fw0[best_e].unbind(1),
                                  inst.fw1[best_e].unbind(1), tt)
    return _world_hit(clusters, xf,
                      None if inst.imat is None else inst.imat[best_e],
                      best_t, best_slot)


def _world_hit(clusters, xf, imat, best_t, best_slot):
    """The closest-hit result of an instanced query: the winner's
    object-space normal taken to world space by its placement's 12
    world->object entries ``xf`` (columns), the material from the table
    or the placement's override ``imat`` ((R,), -1 keeps the table's;
    None: no overrides)."""
    n_obj, mat = lookup_hit(clusters, best_slot)
    # World normal = Lᵀ·n_obj (rows of Lᵀ are columns of L), renormalised.
    n0, n1, n2 = n_obj[:, 0], n_obj[:, 1], n_obj[:, 2]
    nw = [xf[0] * n0 + xf[3] * n1 + xf[6] * n2,
          xf[1] * n0 + xf[4] * n1 + xf[7] * n2,
          xf[2] * n0 + xf[5] * n1 + xf[8] * n2]
    inv_len = torch.rsqrt(torch.clamp(
        nw[0] * nw[0] + nw[1] * nw[1] + nw[2] * nw[2], min=1e-30))
    normal = torch.stack([c * inv_len for c in nw], dim=1)
    miss = best_slot < 0
    normal = torch.where(miss[:, None], 0.0, normal)
    mat = torch.where(miss, 0, mat)
    if imat is not None:
        mat = torch.where(~miss & (imat >= 0), imat, mat)
    return best_t, best_slot, normal, mat


def occluded_inst_torch(clusters, inst, origin, direction, t_max, time=None,
                        stats=None):
    """Plain instanced any-hit sweep: equal to
    ``trace_inst_torch(..., t_max)[1] >= 0`` (the JAX package's any-hit
    oracle), with lanes retired once a hit is found. Never reads
    ``inst.imat``. ``stats`` as in ``trace_torch``."""
    r = origin.shape[0]
    dev = origin.device
    cap = t_max.to(torch.float32)
    occ = torch.zeros(r, dtype=torch.bool, device=dev)
    tt = _shutter_time(inst, time, r, dev)
    inv_d = _safe_inv(direction)
    cmap = inst.cmap.tolist()
    n_slab = n_eval = 0
    for e in range(inst.cmap.shape[0]):
        live = (cap > 0.0) & ~occ
        hit = live & _slab(origin, inv_d, inst.aabb_min[e],
                           inst.aabb_max[e], cap)
        idx = torch.nonzero(hit).squeeze(1)
        if stats is not None:
            n_slab += int(live.sum())
            n_eval += idx.numel()
        if idx.numel() == 0:
            continue
        o_e, d_e = _object_rays(inst, e, origin[idx], direction[idx],
                                None if tt is None else tt[idx])
        t_pair = _pair_eval(o_e, d_e, clusters.woop[cmap[e]],
                            cap[idx][:, None])
        occ[idx] = torch.min(t_pair, dim=1).values < cap[idx]
    if stats is not None:
        stats["slab_tests"] = n_slab
        stats["cluster_evals"] = n_eval
    return occ


# --- two-level instanced plain torch versions ---------------------------


def _walk_inst_torch(clusters, itree, origin, direction, best_t, best_slot,
                     best_p, stats, occ=None, counts=None):
    """Per-ray two-level walk of an ``InstanceTree``, all walking rays
    stepping together. A ray at the top level slab-tests its next node of
    the tree over the placement boxes in world space and moves along its
    own octant's links; at a placement leaf it pierces it enters the
    placement: its ray goes into the placement's object space
    (``_ray_to_object``) and walks the prototype's tree from the
    placement's root as ``_walk_torch`` walks a flat tree (that ray's own
    octant, leaves evaluated against their clusters), then comes back to
    the top level. t stays the world t. Closest hit: in place on
    ``best_t`` / ``best_slot`` / ``best_p`` (the winning placement).
    Any hit (``occ`` given): ``best_t`` is the fixed cap and a ray is
    retired at its first hit. ``stats`` (a dict or None) receives
    ``slab_tests``, ``cluster_evals``, ``placements_entered`` and
    ``proto_clusters_tested``. ``counts`` (``WALK_COUNTS``, or None) has
    the last two added to it, as the kernels' counting launches add
    them."""
    dev = origin.device
    r = origin.shape[0]
    n_top = itree.node_box.shape[1]
    n_forest = itree.forest_box.shape[1]
    live = best_t > 0.0
    if occ is not None:
        live = live & ~occ
    top = torch.where(live, 0, n_top).long()        # next top node
    place = torch.full((r,), -1, dtype=torch.int64, device=dev)
    node = torch.zeros(r, dtype=torch.int64, device=dev)   # forest node
    q_o = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    q_d = torch.zeros_like(q_o)
    inv_d, octant = _safe_inv(direction), _octant(direction)
    q_inv, q_oct = torch.zeros_like(q_o), torch.zeros_like(octant)
    top_links = itree.oct_links.reshape(16, n_top)
    forest_links = itree.forest_links.reshape(16, n_forest)
    n_slab = n_eval = n_enter = 0
    while True:
        # Rays in a placement whose walk has ended go back to the top.
        place = torch.where((place >= 0) & (node >= n_forest), -1, place)
        up = torch.nonzero((place < 0) & (top < n_top)).squeeze(1)
        down = torch.nonzero(place >= 0).squeeze(1)
        if up.numel() + down.numel() == 0:
            break
        n_slab += up.numel() + down.numel()
        if up.numel():
            nd = top[up]
            box = itree.node_box[:, nd]
            hit = _slab(origin[up], inv_d[up], box[:3], box[3:], best_t[up])
            pid = itree.node_meta[1, nd].long()
            oc = octant[up]
            top[up] = torch.where(hit, top_links[oc, nd],
                                  top_links[8 + oc, nd]).long()
            enter = hit & (pid >= 0)
            ei, ep = up[enter], pid[enter]
            if ei.numel():
                n_enter += ei.numel()
                o_e, d_e = _ray_to_object(itree.xform[ep].unbind(1),
                                          origin[ei], direction[ei])
                q_o[ei], q_d[ei] = o_e, d_e
                q_inv[ei], q_oct[ei] = _safe_inv(d_e), _octant(d_e)
                place[ei] = ep
                node[ei] = itree.root[ep].long()
        if down.numel():
            nd = node[down]
            box = itree.forest_box[:, nd]
            bt = best_t[down]
            hit = _slab(q_o[down], q_inv[down], box[:3], box[3:], bt)
            cid = itree.forest_meta[1, nd].long()
            oc = q_oct[down]
            nxt = torch.where(hit, forest_links[oc, nd],
                              forest_links[8 + oc, nd]).long()
            leaf = hit & (cid >= 0)
            li = down[leaf]
            if li.numel():
                n_eval += li.numel()
                c = cid[leaf]
                t_pair = _pair_eval(q_o[li], q_d[li], clusters.woop[c],
                                    bt[leaf][:, None])
                if occ is None:
                    _closest_update(t_pair, c, bt[leaf], best_t, best_slot,
                                    li)
                    won = best_t[li] < bt[leaf]
                    best_p[li] = torch.where(won, place[li], best_p[li])
                else:
                    found = torch.min(t_pair, dim=1).values < bt[leaf]
                    occ[li] = found
                    nxt[leaf] = torch.where(found, n_forest, nxt[leaf])
                    top[li[found]] = n_top
            node[down] = nxt
    if stats is not None:
        stats.update(slab_tests=n_slab, cluster_evals=n_eval,
                     placements_entered=n_enter, proto_clusters_tested=n_eval)
    if counts is not None:
        counts += torch.tensor([n_enter, n_eval], dtype=torch.int64,
                               device=counts.device)


def trace_inst_tree_torch(clusters, itree, origin, direction, t_init,
                          stats=None, counts=None):
    """Plain two-level instanced closest hit (``_walk_inst_torch``), the
    kernel's order: strict ``<`` across clusters and the smallest lane on
    a tie within one; the winning placement's transform takes the table's
    object-space normal to world space (Lᵀn, renormalised) and its
    override replaces the material. Against ``trace_inst_torch`` over the
    expanded placements (index order): t bit for bit; slot, normal and
    material equal or t tied. ``stats`` and ``counts`` as in
    ``_walk_inst_torch``."""
    best_t, best_slot = _start(origin, t_init)
    best_p = torch.zeros(origin.shape[0], dtype=torch.int64,
                         device=origin.device)
    _walk_inst_torch(clusters, itree, origin, direction, best_t, best_slot,
                     best_p, stats, counts=counts)
    return _world_hit(clusters, itree.xform[best_p].unbind(1),
                      None if itree.imat is None else itree.imat[best_p],
                      best_t, best_slot)


def occluded_inst_tree_torch(clusters, itree, origin, direction, t_max,
                             stats=None, counts=None):
    """Plain two-level instanced any hit: ``_walk_inst_torch`` with the cap
    fixed, each ray retired at its first occluder; equal to
    ``occluded_inst_torch`` over the expanded placements (occlusion does
    not depend on the order of visits). ``stats`` and ``counts`` as
    there."""
    cap = t_max.to(torch.float32)
    occ = torch.zeros(origin.shape[0], dtype=torch.bool, device=origin.device)
    _walk_inst_torch(clusters, itree, origin, direction, cap, None, None,
                     stats, occ=occ, counts=counts)
    return occ


# --- CUDA kernels ------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # origin, direction, t_init, woop, normal, mat, node_box, node_meta,
    # oct_links, n_rays, n_nodes, t_out, slot_out, normal_out, mat_out,
    # stream
    "ptpu_trace_dnf": [_P] * 9 + [_I, _I] + [_P] * 5,
    # origin, direction, t_max, woop, node_box, node_meta, oct_links,
    # n_rays, n_nodes, occ_out, stream
    "ptpu_occluded_dnf": [_P] * 7 + [_I, _I] + [_P] * 2,
}


_INST_SIGNATURES = {
    # origin, direction, t_init, time, aabb_min, aabb_max, cmap, xform,
    # imat, fw0, fw1, inst_first, inst_min, inst_max, woop, normal, mat,
    # n_rays, n_inst, t_out, slot_out, normal_out, mat_out, stream
    "ptpu_trace_dnf_inst": [_P] * 17 + [_I, _I] + [_P] * 5,
    # origin, direction, t_max, time, aabb_min, aabb_max, cmap, xform, fw0,
    # fw1, inst_first, inst_min, inst_max, woop, n_rays, n_inst, occ_out,
    # stream
    "ptpu_occluded_dnf_inst": [_P] * 14 + [_I, _I] + [_P] * 2,
}


_PAGED_SIGNATURES = {
    # origin, direction, t_init, woop, normal, mat, node_box, node_meta,
    # oct_links, n_rays, n_pages, page_size, page_nodes, t_out, slot_out,
    # normal_out, mat_out, stream
    "ptpu_trace_paged_dnf": [_P] * 9 + [_I] * 4 + [_P] * 5,
    # origin, direction, t_max, woop, node_box, node_meta, oct_links,
    # n_rays, n_pages, page_size, page_nodes, occ_out, stream
    "ptpu_occluded_paged_dnf": [_P] * 7 + [_I] * 4 + [_P] * 2,
}
_TREE_SIGNATURES = {
    # origin, direction, t_init, node_box, node_meta, links, woop, mat,
    # n_rays, n_nodes, t_out, slot_out, normal_out, mat_out, stream
    "ptpu_trace_tree": [_P] * 8 + [_I, _I] + [_P] * 5,
    # origin, direction, t_max, node_box, node_meta, links, woop, n_rays,
    # n_nodes, occ_out, stream
    "ptpu_occluded_tree": [_P] * 7 + [_I, _I] + [_P] * 2,
    # origin, direction, t_init, node_box, node_meta, links, woop, mat,
    # n_rays, n_pages, page_nodes, page_size, t_out, slot_out, normal_out,
    # mat_out, stream
    "ptpu_trace_tree_paged": [_P] * 8 + [_I] * 4 + [_P] * 5,
}


_INST_TREE_SIGNATURES = {
    # origin, direction, t_init, node_box, node_meta, oct_links, xform,
    # root, imat, forest_box, forest_meta, forest_links, woop, normal, mat,
    # n_rays, n_nodes, n_forest, t_out, slot_out, normal_out, mat_out,
    # counts, stream
    "ptpu_trace_inst_tree": [_P] * 15 + [_I] * 3 + [_P] * 6,
    # origin, direction, t_max, node_box, node_meta, oct_links, xform,
    # root, forest_box, forest_meta, forest_links, woop, n_rays, n_nodes,
    # n_forest, occ_out, counts, stream
    "ptpu_occluded_inst_tree": [_P] * 12 + [_I] * 3 + [_P] * 3,
}


def _library():
    return cuda_build.load("cluster_trace", _SIGNATURES)


def _inst_library():
    return cuda_build.load("cluster_trace_inst", _INST_SIGNATURES)


def _checked(t, dtype, shape, name):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    return t.contiguous()


def _ray_args(origin, direction, t_cap, cap_name):
    r = origin.shape[0]
    return r, (
        _checked(origin, torch.float32, (r, 3), "origin"),
        _checked(direction, torch.float32, (r, 3), "direction"),
        _checked(t_cap, torch.float32, (r,), cap_name),
    )


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def trace(clusters, origin, direction, t_init):
    """Closest hit (see the module contract) by a walk of the flat set's
    cluster tree; a set without a tree raises. CPU tensors take
    ``trace_flat_walk_torch``; CUDA tensors launch ``trace_dnf_kernel``."""
    dev = origin.device
    if dev.type == "cpu":
        return trace_flat_walk_torch(clusters, origin, direction, t_init)
    r, rays = _ray_args(origin, direction, t_init, "t_init")
    n, *tree = _tree_args(clusters, dev)
    tables = _hit_tables(clusters, dev)
    out = _closest_out(r, dev)
    if r == 0:
        return out
    err = _library().ptpu_trace_dnf(
        *(x.data_ptr() for x in rays), *(x.data_ptr() for x in tables),
        *(x.data_ptr() for x in tree), r, n, *(x.data_ptr() for x in out),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "trace_dnf_kernel")
    LAUNCHES["trace"] += 1
    return out


def occluded(clusters, origin, direction, t_max):
    """Any-hit occlusion (see the module contract) by a walk of the flat
    set's cluster tree; a set without a tree raises. CPU tensors take
    ``occluded_tree_torch``; CUDA tensors launch ``occluded_dnf_kernel``."""
    dev = origin.device
    if dev.type == "cpu":
        return occluded_tree_torch(clusters, origin, direction, t_max)
    r, rays = _ray_args(origin, direction, t_max, "t_max")
    n, *tree = _tree_args(clusters, dev)
    woop = _hit_tables(clusters, dev)[0]
    occ = torch.empty(r, dtype=torch.bool, device=dev)
    if r == 0:
        return occ
    err = _library().ptpu_occluded_dnf(
        *(x.data_ptr() for x in rays), woop.data_ptr(),
        *(x.data_ptr() for x in tree), r, n, occ.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "occluded_dnf_kernel")
    LAUNCHES["occluded"] += 1
    return occ


def _same_device(tensors, device):
    for t in tensors:
        if t is not None and t.device != device:
            raise ValueError("tables and rays lie on different devices "
                             f"({t.device} vs {device})")


def _inst_args(clusters, inst, r, time, device, with_imat):
    """Checked, contiguous kernel operands of an instanced query:
    (per-ray time or None, (aabb_min, aabb_max, cmap, xform), imat or None,
    (fw0, fw1) or (None, None), woop)."""
    ce = inst.cmap.shape[0]
    c = clusters.woop.shape[0]
    tables = (
        _checked(inst.aabb_min, torch.float32, (ce, 3), "inst.aabb_min"),
        _checked(inst.aabb_max, torch.float32, (ce, 3), "inst.aabb_max"),
        _checked(inst.cmap, torch.int32, (ce,), "inst.cmap"),
        _checked(inst.xform, torch.float32, (ce, 12), "inst.xform"),
    )
    imat = None
    if with_imat and inst.imat is not None:
        imat = _checked(inst.imat, torch.int32, (ce,), "inst.imat")
    motion = (None, None)
    tt = _shutter_time(inst, time, r, device)
    if tt is not None:
        motion = (_checked(inst.fw0, torch.float32, (ce, 12), "inst.fw0"),
                  _checked(inst.fw1, torch.float32, (ce, 12), "inst.fw1"))
        tt = _checked(tt, torch.float32, (r,), "time")
    woop = _checked(clusters.woop, torch.float32, (c, 4, 3 * CLUSTER_SIZE),
                    "woop")
    _same_device((*tables, imat, *motion, woop, tt), device)
    return tt, tables, imat, motion, woop


def _ptr(t):
    return None if t is None else t.data_ptr()


def _placement_args(inst, device):
    """Checked (n_inst, (inst_first, inst_min, inst_max)) of an instance
    set: the placement runs and boxes that both instanced kernels cull
    by."""
    if inst.inst_first is None:
        raise ValueError("this InstanceSet carries no placement boxes "
                         "(ops.clusters.placement_boxes)")
    p = inst.inst_first.shape[0] - 1
    tables = (
        _checked(inst.inst_first, torch.int32, (p + 1,), "inst.inst_first"),
        _checked(inst.inst_min, torch.float32, (p, 3), "inst.inst_min"),
        _checked(inst.inst_max, torch.float32, (p, 3), "inst.inst_max"),
    )
    _same_device(tables, device)
    return p, tables


def trace_inst(clusters, inst, origin, direction, t_init, time=None):
    """Instanced closest hit (see the module contract). An empty instance
    set passes ``t_init`` through without a sweep. CPU tensors take
    ``trace_inst_torch``; CUDA tensors launch ``trace_dnf_inst_kernel``,
    which culls whole placements by ``inst.inst_min``/``inst_max`` first
    (exact: the same pairs in the same order as ``trace_inst_torch``)."""
    dev = origin.device
    if inst.cmap.shape[0] == 0:
        return _no_hit(t_init)
    if dev.type == "cpu":
        return trace_inst_torch(clusters, inst, origin, direction, t_init,
                                time=time)
    r, rays = _ray_args(origin, direction, t_init, "t_init")
    tt, tables, imat, motion, woop = _inst_args(clusters, inst, r, time,
                                                dev, with_imat=True)
    n_inst, places = _placement_args(inst, dev)
    c = woop.shape[0]
    normal_tab = _checked(clusters.normal, torch.float32,
                          (c, 3, CLUSTER_SIZE), "normal")
    mat_tab = _checked(clusters.mat, torch.int32, (c, CLUSTER_SIZE), "mat")
    _same_device((normal_tab, mat_tab), dev)
    t = torch.empty(r, dtype=torch.float32, device=dev)
    slot = torch.empty(r, dtype=torch.int32, device=dev)
    normal = torch.empty((r, 3), dtype=torch.float32, device=dev)
    mat = torch.empty(r, dtype=torch.int32, device=dev)
    if r == 0:
        return t, slot, normal, mat
    lib = _inst_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ptpu_trace_dnf_inst(
        *(x.data_ptr() for x in rays), _ptr(tt),
        *(x.data_ptr() for x in tables), _ptr(imat), _ptr(motion[0]),
        _ptr(motion[1]), *(x.data_ptr() for x in places), woop.data_ptr(),
        normal_tab.data_ptr(), mat_tab.data_ptr(), r, n_inst, t.data_ptr(),
        slot.data_ptr(), normal.data_ptr(), mat.data_ptr(), stream,
    )
    _raise_on(err, "trace_dnf_inst_kernel")
    LAUNCHES["trace_inst"] += 1
    return t, slot, normal, mat


def occluded_inst(clusters, inst, origin, direction, t_max, time=None):
    """Instanced any-hit occlusion (see the module contract); never reads
    the material override. An empty instance set occludes nothing. CPU
    tensors take ``occluded_inst_torch``; CUDA tensors launch
    ``occluded_dnf_inst_kernel``, which culls whole placements as
    ``trace_inst`` does and retires a lane at its first occluder (the same
    bool as ``occluded_inst_torch``: occlusion does not depend on the order
    of visits)."""
    r = origin.shape[0]
    dev = origin.device
    if inst.cmap.shape[0] == 0:
        return torch.zeros(r, dtype=torch.bool, device=dev)
    if dev.type == "cpu":
        return occluded_inst_torch(clusters, inst, origin, direction, t_max,
                                   time=time)
    r, rays = _ray_args(origin, direction, t_max, "t_max")
    tt, tables, _, motion, woop = _inst_args(clusters, inst, r, time, dev,
                                             with_imat=False)
    n_inst, places = _placement_args(inst, dev)
    occ = torch.empty(r, dtype=torch.bool, device=dev)
    if r == 0:
        return occ
    lib = _inst_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ptpu_occluded_dnf_inst(
        *(x.data_ptr() for x in rays), _ptr(tt),
        *(x.data_ptr() for x in tables), _ptr(motion[0]), _ptr(motion[1]),
        *(x.data_ptr() for x in places), woop.data_ptr(), r, n_inst,
        occ.data_ptr(), stream,
    )
    _raise_on(err, "occluded_dnf_inst_kernel")
    LAUNCHES["occluded_inst"] += 1
    return occ


# --- big-scene kernels (paged sweep, cluster-tree walks) -----------------


def _paged_library():
    return cuda_build.load("cluster_trace_paged", _PAGED_SIGNATURES)


def _tree_library():
    return cuda_build.load("cluster_trace_tree", _TREE_SIGNATURES)


def _closest_out(r, device):
    return (torch.empty(r, dtype=torch.float32, device=device),
            torch.empty(r, dtype=torch.int32, device=device),
            torch.empty((r, 3), dtype=torch.float32, device=device),
            torch.empty(r, dtype=torch.int32, device=device))


def _page_args(clusters, pages, device):
    """Checked (n_pages, page_size, page_nodes, node_box, node_meta,
    oct_links) of a PageSet over ``clusters``."""
    g, _, n = pages.node_box.shape
    c = clusters.woop.shape[0]
    if g == 0 or c % g:
        raise ValueError(f"{c} clusters do not split into {g} pages")
    tables = (
        _checked(pages.node_box, torch.float32, (g, 6, n), "pages.node_box"),
        _checked(pages.node_meta, torch.int32, (g, 2, n), "pages.node_meta"),
        _checked(pages.oct_links, torch.int32, (g, 16, n),
                 "pages.oct_links"),
    )
    _same_device(tables, device)
    return (g, c // g, n) + tables


def _hit_tables(clusters, device):
    c = clusters.woop.shape[0]
    tables = (
        _checked(clusters.woop, torch.float32, (c, 4, 3 * CLUSTER_SIZE),
                 "woop"),
        _checked(clusters.normal, torch.float32, (c, 3, CLUSTER_SIZE),
                 "normal"),
        _checked(clusters.mat, torch.int32, (c, CLUSTER_SIZE), "mat"),
    )
    _same_device(tables, device)
    return tables


def trace_paged_dnf(clusters, pages, origin, direction, t_init):
    """Paged closest hit (see the module contract). CPU tensors take
    ``trace_paged_walk_torch``; CUDA tensors launch
    ``trace_paged_dnf_kernel``."""
    dev = origin.device
    if dev.type == "cpu":
        return trace_paged_walk_torch(clusters, pages, origin, direction,
                                      t_init)
    r, rays = _ray_args(origin, direction, t_init, "t_init")
    g, page_size, page_nodes, *tree = _page_args(clusters, pages, dev)
    tables = _hit_tables(clusters, dev)
    out = _closest_out(r, dev)
    if r == 0:
        return out
    err = _paged_library().ptpu_trace_paged_dnf(
        *(x.data_ptr() for x in rays), *(x.data_ptr() for x in tables),
        *(x.data_ptr() for x in tree), r, g, page_size, page_nodes,
        *(x.data_ptr() for x in out),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "trace_paged_dnf_kernel")
    LAUNCHES["trace_paged_dnf"] += 1
    return out


def occluded_paged_dnf(clusters, pages, origin, direction, t_max):
    """Paged any-hit occlusion (see the module contract). CPU tensors take
    ``occluded_paged_dnf_torch``; CUDA tensors launch
    ``occluded_paged_dnf_kernel``."""
    dev = origin.device
    if dev.type == "cpu":
        return occluded_paged_dnf_torch(clusters, pages, origin, direction,
                                        t_max)
    r, rays = _ray_args(origin, direction, t_max, "t_max")
    g, page_size, page_nodes, *tree = _page_args(clusters, pages, dev)
    woop = _hit_tables(clusters, dev)[0]
    occ = torch.empty(r, dtype=torch.bool, device=dev)
    if r == 0:
        return occ
    err = _paged_library().ptpu_occluded_paged_dnf(
        *(x.data_ptr() for x in rays), woop.data_ptr(),
        *(x.data_ptr() for x in tree), r, g, page_size, page_nodes,
        occ.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "occluded_paged_dnf_kernel")
    LAUNCHES["occluded_paged_dnf"] += 1
    return occ


def _tree_args(clusters, device):
    """Checked (n_nodes, node_box, node_meta, oct_links) of a flat set."""
    _require_tree(clusters)
    n = clusters.node_box.shape[1]
    tables = (
        _checked(clusters.node_box, torch.float32, (6, n), "node_box"),
        _checked(clusters.node_meta, torch.int32, (2, n), "node_meta"),
        _checked(clusters.oct_links, torch.int32, (2, 8, n), "oct_links"),
    )
    _same_device(tables, device)
    return (n,) + tables


def trace_tree(clusters, origin, direction, t_init):
    """Closest hit by the per-ray cluster-tree walk (see the module
    contract). CPU tensors take ``trace_tree_torch``; CUDA tensors launch
    ``trace_tree_kernel``."""
    dev = origin.device
    if dev.type == "cpu":
        return trace_tree_torch(clusters, origin, direction, t_init)
    r, rays = _ray_args(origin, direction, t_init, "t_init")
    n, *tree = _tree_args(clusters, dev)
    woop, _, mat_tab = _hit_tables(clusters, dev)
    out = _closest_out(r, dev)
    if r == 0:
        return out
    err = _tree_library().ptpu_trace_tree(
        *(x.data_ptr() for x in rays), *(x.data_ptr() for x in tree),
        woop.data_ptr(), mat_tab.data_ptr(), r, n,
        *(x.data_ptr() for x in out),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "trace_tree_kernel")
    LAUNCHES["trace_tree"] += 1
    return out


def occluded_tree(clusters, origin, direction, t_max):
    """Any-hit occlusion by the per-ray cluster-tree walk (see the module
    contract). CPU tensors take ``occluded_tree_torch``; CUDA tensors
    launch ``occluded_tree_kernel``."""
    dev = origin.device
    if dev.type == "cpu":
        return occluded_tree_torch(clusters, origin, direction, t_max)
    r, rays = _ray_args(origin, direction, t_max, "t_max")
    n, *tree = _tree_args(clusters, dev)
    woop = _hit_tables(clusters, dev)[0]
    occ = torch.empty(r, dtype=torch.bool, device=dev)
    if r == 0:
        return occ
    err = _tree_library().ptpu_occluded_tree(
        *(x.data_ptr() for x in rays), *(x.data_ptr() for x in tree),
        woop.data_ptr(), r, n, occ.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "occluded_tree_kernel")
    LAUNCHES["occluded_tree"] += 1
    return occ


def trace_tree_paged(clusters, pages, origin, direction, t_init):
    """Closest hit by the per-ray walk of each page's tree, pages nearest
    first (see the module contract). CPU tensors take
    ``trace_tree_paged_walk_torch``; CUDA tensors launch
    ``trace_tree_paged_kernel``."""
    dev = origin.device
    if dev.type == "cpu":
        return trace_tree_paged_walk_torch(clusters, pages, origin,
                                           direction, t_init)
    r, rays = _ray_args(origin, direction, t_init, "t_init")
    g, page_size, page_nodes, *tree = _page_args(clusters, pages, dev)
    woop, _, mat_tab = _hit_tables(clusters, dev)
    out = _closest_out(r, dev)
    if r == 0:
        return out
    err = _tree_library().ptpu_trace_tree_paged(
        *(x.data_ptr() for x in rays), *(x.data_ptr() for x in tree),
        woop.data_ptr(), mat_tab.data_ptr(), r, g, page_nodes, page_size,
        *(x.data_ptr() for x in out),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "trace_tree_paged_kernel")
    LAUNCHES["trace_tree_paged"] += 1
    return out


# --- two-level instanced kernels ----------------------------------------


def _inst_tree_library():
    return cuda_build.load("cluster_trace_inst_tree", _INST_TREE_SIGNATURES)


def _inst_tree_args(itree, device):
    """Checked (n_nodes, n_forest, (node_box, node_meta, oct_links, xform,
    root), (forest_box, forest_meta, forest_links)) of an InstanceTree."""
    p = itree.xform.shape[0]
    n = itree.node_box.shape[1]
    f = itree.forest_box.shape[1]
    top = (
        _checked(itree.node_box, torch.float32, (6, n), "itree.node_box"),
        _checked(itree.node_meta, torch.int32, (2, n), "itree.node_meta"),
        _checked(itree.oct_links, torch.int32, (2, 8, n), "itree.oct_links"),
        _checked(itree.xform, torch.float32, (p, 12), "itree.xform"),
        _checked(itree.root, torch.int32, (p,), "itree.root"),
    )
    forest = (
        _checked(itree.forest_box, torch.float32, (6, f), "itree.forest_box"),
        _checked(itree.forest_meta, torch.int32, (2, f),
                 "itree.forest_meta"),
        _checked(itree.forest_links, torch.int32, (2, 8, f),
                 "itree.forest_links"),
    )
    _same_device(top + forest, device)
    return n, f, top, forest


def walk_counts(device):
    """A zeroed counter of ``WALK_COUNTS`` for the two-level walks'
    ``counts``: (2,) int64 on ``device``."""
    return torch.zeros(len(WALK_COUNTS), dtype=torch.int64, device=device)


def _counts_arg(counts, device):
    if counts is None:
        return None
    _checked(counts, torch.int64, (len(WALK_COUNTS),), "counts")
    _same_device((counts,), device)
    return counts


def trace_inst_tree(clusters, itree, origin, direction, t_init,
                    counts=None):
    """Closest hit of a two-level instanced scene (see the module
    contract; ``slot`` is a slot of the combined ClusterSet, ``normal`` in
    world space, ``mat`` with the placement's override). CPU tensors take
    ``trace_inst_tree_torch``; CUDA tensors launch
    ``trace_inst_tree_kernel``, its counting instantiation where
    ``counts`` (``WALK_COUNTS``) is given."""
    dev = origin.device
    if dev.type == "cpu":
        return trace_inst_tree_torch(clusters, itree, origin, direction,
                                     t_init, counts=counts)
    r, rays = _ray_args(origin, direction, t_init, "t_init")
    n, f, top, forest = _inst_tree_args(itree, dev)
    imat = None
    if itree.imat is not None:
        imat = _checked(itree.imat, torch.int32, (itree.xform.shape[0],),
                        "itree.imat")
    tables = _hit_tables(clusters, dev)
    out = _closest_out(r, dev)
    if r == 0:
        return out
    err = _inst_tree_library().ptpu_trace_inst_tree(
        *(x.data_ptr() for x in rays), *(x.data_ptr() for x in top),
        _ptr(imat), *(x.data_ptr() for x in forest),
        *(x.data_ptr() for x in tables), r, n, f,
        *(x.data_ptr() for x in out), _ptr(_counts_arg(counts, dev)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "trace_inst_tree_kernel")
    LAUNCHES["trace_inst_tree"] += 1
    return out


def occluded_inst_tree(clusters, itree, origin, direction, t_max,
                       counts=None):
    """Any-hit occlusion of a two-level instanced scene (see the module
    contract). CPU tensors take ``occluded_inst_tree_torch``; CUDA tensors
    launch ``occluded_inst_tree_kernel``, its counting instantiation where
    ``counts`` (``WALK_COUNTS``) is given."""
    dev = origin.device
    if dev.type == "cpu":
        return occluded_inst_tree_torch(clusters, itree, origin, direction,
                                        t_max, counts=counts)
    r, rays = _ray_args(origin, direction, t_max, "t_max")
    n, f, top, forest = _inst_tree_args(itree, dev)
    woop = _hit_tables(clusters, dev)[0]
    occ = torch.empty(r, dtype=torch.bool, device=dev)
    if r == 0:
        return occ
    err = _inst_tree_library().ptpu_occluded_inst_tree(
        *(x.data_ptr() for x in rays), *(x.data_ptr() for x in top),
        *(x.data_ptr() for x in forest), woop.data_ptr(),
        r, n, f, occ.data_ptr(), _ptr(_counts_arg(counts, dev)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "occluded_inst_tree_kernel")
    LAUNCHES["occluded_inst_tree"] += 1
    return occ
