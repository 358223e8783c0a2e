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
takes the plain version (``trace_torch`` / ``occluded_torch``, a torch port
of the JAX package's ``trace_jax`` sweep), a CUDA tensor launches the
hand-written kernel in ``csrc/cluster_trace.cu`` or raises. Each launch
adds one to ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch

from pathtracing_tpu_torch.ops import cuda_build
from pathtracing_tpu_torch.ops.clusters import CLUSTER_SIZE
from pathtracing_tpu_torch.ops.intersect import T_MIN

_BIG = 3.0e38
# Cluster-count ceiling of the JAX package's flat DNF kernels; the port's
# SceneBuilder refuses larger scenes until the paged/tree kernels exist.
DNF_MAX_CLUSTERS = 8192

# Launch counts of the CUDA kernels (a run resets them to 0 before the
# path it wants to account for and reads them after).
LAUNCHES = {"trace": 0, "occluded": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --- plain torch versions ----------------------------------------------


def _safe_inv(d3):
    tiny = torch.where(d3 >= 0, 1e-12, -1e-12)
    return 1.0 / torch.where(torch.abs(d3) < 1e-12, tiny, d3)


def _slab(origin, inv_d, bmin, bmax, best_t):
    """Rays × one AABB slab test (the JAX ``_slab6``). Returns (R,) bool."""
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
    broadcast multiply-adds in a fixed order, no matmul. ``best_t`` is
    (n, 1). Returns t (n, 128) with misses at _BIG."""
    op = woop_c[3] + origin[:, 0:1] * woop_c[0]
    op = op + origin[:, 1:2] * woop_c[1]
    op = op + origin[:, 2:3] * woop_c[2]
    dp = direction[:, 0:1] * woop_c[0]
    dp = dp + direction[:, 1:2] * woop_c[1]
    dp = dp + direction[:, 2:3] * woop_c[2]
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


def trace_torch(clusters, origin, direction, t_init, stats=None):
    """Plain closest-hit sweep: every cluster in index order, strict ``<``
    across clusters and the smallest lane on a tie within one (the JAX
    ``trace_jax`` tie rule). Only the rays whose slab test passes are
    evaluated against a cluster — elementwise the same arithmetic, so the
    result equals the fully masked sweep. ``stats`` (optional dict)
    receives ``slab_tests`` and ``cluster_evals``: the (ray, cluster)
    pairs this input needs."""
    r = origin.shape[0]
    n_clusters = clusters.woop.shape[0]
    best_t = t_init.to(torch.float32).clone()
    best_slot = torch.full((r,), -1, dtype=torch.int32, device=origin.device)
    inv_d = _safe_inv(direction)
    lane = torch.arange(CLUSTER_SIZE, dtype=torch.int32, device=origin.device)
    n_slab = n_eval = 0
    for c in range(n_clusters):
        live = best_t > 0.0
        hit = live & _slab(origin, inv_d, clusters.aabb_min[c],
                           clusters.aabb_max[c], best_t)
        idx = torch.nonzero(hit).squeeze(1)
        if stats is not None:
            n_slab += int(live.sum())
            n_eval += idx.numel()
        if idx.numel() == 0:
            continue
        bt = best_t[idx]
        t_pair = _pair_eval(origin[idx], direction[idx], clusters.woop[c],
                            bt[:, None])
        t_min = torch.min(t_pair, dim=1).values
        slot = torch.min(
            torch.where(t_pair <= t_min[:, None], lane, CLUSTER_SIZE), dim=1
        ).values
        upd = t_min < bt
        best_t[idx] = torch.where(upd, t_min, bt)
        best_slot[idx] = torch.where(upd, c * CLUSTER_SIZE + slot,
                                     best_slot[idx])
    if stats is not None:
        stats["slab_tests"] = n_slab
        stats["cluster_evals"] = n_eval
    normal, mat = lookup_hit(clusters, best_slot)
    miss = best_slot < 0
    normal = torch.where(miss[:, None], 0.0, normal)
    mat = torch.where(miss, 0, mat)
    return best_t, best_slot, normal, mat


def occluded_torch(clusters, origin, direction, t_max, stats=None):
    """Plain any-hit sweep: equal to ``trace_torch(..., t_max)[1] >= 0``
    (the JAX package's any-hit oracle), with lanes retired once a hit is
    found. ``stats`` as in ``trace_torch``."""
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


# --- CUDA kernels ------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # origin, direction, t_init, aabb_min, aabb_max, woop, normal, mat,
    # n_rays, n_clusters, t_out, slot_out, normal_out, mat_out, stream
    "ptpu_trace_dnf": [_P] * 8 + [_I, _I] + [_P] * 5,
    # origin, direction, t_max, aabb_min, aabb_max, woop, n_rays,
    # n_clusters, occ_out, stream
    "ptpu_occluded_dnf": [_P] * 6 + [_I, _I] + [_P] * 2,
}


def _library():
    return cuda_build.load("cluster_trace", _SIGNATURES)


def _checked(t, dtype, shape, name):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    return t.contiguous()


def _cluster_args(clusters, device):
    c = clusters.woop.shape[0]
    k = CLUSTER_SIZE
    tables = (
        _checked(clusters.aabb_min, torch.float32, (c, 3), "aabb_min"),
        _checked(clusters.aabb_max, torch.float32, (c, 3), "aabb_max"),
        _checked(clusters.woop, torch.float32, (c, 4, 3 * k), "woop"),
    )
    for t in tables:
        if t.device != device:
            raise ValueError("cluster tables and rays lie on different "
                             f"devices ({t.device} vs {device})")
    return c, tables


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
    """Closest hit (see the module contract). CPU tensors take
    ``trace_torch``; CUDA tensors launch ``trace_dnf_kernel``."""
    if origin.device.type == "cpu":
        return trace_torch(clusters, origin, direction, t_init)
    r, rays = _ray_args(origin, direction, t_init, "t_init")
    c, (bmin, bmax, woop) = _cluster_args(clusters, origin.device)
    normal_tab = _checked(clusters.normal, torch.float32,
                          (c, 3, CLUSTER_SIZE), "normal")
    mat_tab = _checked(clusters.mat, torch.int32, (c, CLUSTER_SIZE), "mat")
    t = torch.empty(r, dtype=torch.float32, device=origin.device)
    slot = torch.empty(r, dtype=torch.int32, device=origin.device)
    normal = torch.empty((r, 3), dtype=torch.float32, device=origin.device)
    mat = torch.empty(r, dtype=torch.int32, device=origin.device)
    if r == 0:
        return t, slot, normal, mat
    lib = _library()
    stream = torch.cuda.current_stream(origin.device).cuda_stream
    err = lib.ptpu_trace_dnf(
        *(x.data_ptr() for x in rays), bmin.data_ptr(), bmax.data_ptr(),
        woop.data_ptr(), normal_tab.data_ptr(), mat_tab.data_ptr(), r, c,
        t.data_ptr(), slot.data_ptr(), normal.data_ptr(), mat.data_ptr(),
        stream,
    )
    _raise_on(err, "trace_dnf_kernel")
    LAUNCHES["trace"] += 1
    return t, slot, normal, mat


def occluded(clusters, origin, direction, t_max):
    """Any-hit occlusion (see the module contract). CPU tensors take
    ``occluded_torch``; CUDA tensors launch ``occluded_dnf_kernel``."""
    if origin.device.type == "cpu":
        return occluded_torch(clusters, origin, direction, t_max)
    r, rays = _ray_args(origin, direction, t_max, "t_max")
    c, (bmin, bmax, woop) = _cluster_args(clusters, origin.device)
    occ = torch.empty(r, dtype=torch.bool, device=origin.device)
    if r == 0:
        return occ
    lib = _library()
    stream = torch.cuda.current_stream(origin.device).cuda_stream
    err = lib.ptpu_occluded_dnf(
        *(x.data_ptr() for x in rays), bmin.data_ptr(), bmax.data_ptr(),
        woop.data_ptr(), r, c, occ.data_ptr(), stream,
    )
    _raise_on(err, "occluded_dnf_kernel")
    LAUNCHES["occluded"] += 1
    return occ
