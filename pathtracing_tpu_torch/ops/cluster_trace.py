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

Instanced scenes (``ops.clusters.InstanceSet``) go through

  trace_inst(clusters, inst, origin, direction, t_init, time=None)
  occluded_inst(clusters, inst, origin, direction, t_max, time=None)

with the same contract over expanded (instance, prototype cluster) world
boxes: ``slot`` is a PROTOTYPE slot, ``normal`` is in world space, ``mat``
carries the per-instance override, and ``time`` is the per-ray shutter time
of a motion-blurred set (mid-shutter when None; ignored by static sets).
Plain versions ``trace_inst_torch`` / ``occluded_inst_torch`` (a port of
``trace_jax_inst``); kernels in ``csrc/cluster_trace_inst.cu``.
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
LAUNCHES = {"trace": 0, "occluded": 0, "trace_inst": 0,
            "occluded_inst": 0}


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
    n_obj, mat = lookup_hit(clusters, best_slot)
    if tt is None:
        xf = inst.xform[best_e].unbind(1)
    else:
        xf = _lerp_affine_inverse(inst.fw0[best_e].unbind(1),
                                  inst.fw1[best_e].unbind(1), tt)
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
    if inst.imat is not None:
        im = inst.imat[best_e]
        mat = torch.where(~miss & (im >= 0), im, mat)
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


_INST_SIGNATURES = {
    # origin, direction, t_init, time, aabb_min, aabb_max, cmap, xform,
    # imat, fw0, fw1, woop, normal, mat, n_rays, n_exp, t_out, slot_out,
    # normal_out, mat_out, stream
    "ptpu_trace_dnf_inst": [_P] * 14 + [_I, _I] + [_P] * 5,
    # origin, direction, t_max, time, aabb_min, aabb_max, cmap, xform, fw0,
    # fw1, woop, n_rays, n_exp, occ_out, stream
    "ptpu_occluded_dnf_inst": [_P] * 11 + [_I, _I] + [_P] * 2,
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


def _same_device(tensors, device):
    for t in tensors:
        if t is not None and t.device != device:
            raise ValueError("instance tables and rays lie on different "
                             f"devices ({t.device} vs {device})")


def _inst_args(clusters, inst, r, time, device, with_imat):
    """Checked, contiguous kernel operands of an instanced query:
    (n_exp, per-ray time or None, (aabb_min, aabb_max, cmap, xform), imat
    or None, (fw0, fw1) or (None, None), woop)."""
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
    return ce, tt, tables, imat, motion, woop


def _ptr(t):
    return None if t is None else t.data_ptr()


def trace_inst(clusters, inst, origin, direction, t_init, time=None):
    """Instanced closest hit (see the module contract). An empty instance
    set passes ``t_init`` through without a sweep. CPU tensors take
    ``trace_inst_torch``; CUDA tensors launch ``trace_dnf_inst_kernel``."""
    dev = origin.device
    if inst.cmap.shape[0] == 0:
        return _no_hit(t_init)
    if dev.type == "cpu":
        return trace_inst_torch(clusters, inst, origin, direction, t_init,
                                time=time)
    r, rays = _ray_args(origin, direction, t_init, "t_init")
    ce, tt, tables, imat, motion, woop = _inst_args(clusters, inst, r, time,
                                                    dev, with_imat=True)
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
        _ptr(motion[1]), woop.data_ptr(), normal_tab.data_ptr(),
        mat_tab.data_ptr(), r, ce, t.data_ptr(), slot.data_ptr(),
        normal.data_ptr(), mat.data_ptr(), stream,
    )
    _raise_on(err, "trace_dnf_inst_kernel")
    LAUNCHES["trace_inst"] += 1
    return t, slot, normal, mat


def occluded_inst(clusters, inst, origin, direction, t_max, time=None):
    """Instanced any-hit occlusion (see the module contract); never reads
    the material override. An empty instance set occludes nothing. CPU
    tensors take ``occluded_inst_torch``; CUDA tensors launch
    ``occluded_dnf_inst_kernel``."""
    r = origin.shape[0]
    dev = origin.device
    if inst.cmap.shape[0] == 0:
        return torch.zeros(r, dtype=torch.bool, device=dev)
    if dev.type == "cpu":
        return occluded_inst_torch(clusters, inst, origin, direction, t_max,
                                   time=time)
    r, rays = _ray_args(origin, direction, t_max, "t_max")
    ce, tt, tables, _, motion, woop = _inst_args(clusters, inst, r, time,
                                                 dev, with_imat=False)
    occ = torch.empty(r, dtype=torch.bool, device=dev)
    if r == 0:
        return occ
    lib = _inst_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ptpu_occluded_dnf_inst(
        *(x.data_ptr() for x in rays), _ptr(tt),
        *(x.data_ptr() for x in tables), _ptr(motion[0]), _ptr(motion[1]),
        woop.data_ptr(), r, ce, occ.data_ptr(), stream,
    )
    _raise_on(err, "occluded_dnf_inst_kernel")
    LAUNCHES["occluded_inst"] += 1
    return occ
