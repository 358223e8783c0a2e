"""Plain reference path tracer for triangle scenes of Lambertian and
emissive materials: the port's estimator, written again from its
definition in plain torch, with its own intersection.

The estimator (what the port's megakernel computes for such a scene):
pinhole camera rays through LD-jittered film points, then ``max_depth``
bounces without roulette; at each hit the emission, MIS-weighted (power
heuristic) against the previous vertex's light sample; next-event
estimation at each Lambertian vertex by one power-weighted pick of an
emissive triangle, an area-uniform point on it and a shadow ray, weighted
by the power heuristic against the cosine lobe; then a cosine-weighted
scatter. The first vertex takes its NEE and scatter numbers from the LD
sampler, the later ones from the threefry streams (``streams.py``), so a
path here is the program's path for the same (pixel, sample).

Intersection is Moller-Trumbore over the benchmark's own triangle arrays,
after a cull by boxes of Morton-ordered groups of triangles; it shares
nothing with the port's trees, clusters or pages. Hits lie in
(``T_MIN``, t_max), the program's self-intersection rule. ``render``
takes its hits from the geometry object (``closest`` and ``surface``):
``Geometry`` holds flat triangles, ``instanced.Instanced`` placements of
prototypes.

``dtype`` is the float type of every float computation: float32 is the
reference, bfloat16 the control (the nearest precision below the one the
configuration states)."""

from __future__ import annotations

from dataclasses import dataclass
from itertools import permutations

import numpy as np
import torch

from ptbench.reference import streams as rs

INV_PI = 0.3183098861837907
TWO_PI = 6.283185307179586
T_MIN = 1e-3
INF = float("inf")
# Rays x boxes (or pairs x triangles) a block of the intersection holds.
BLOCK_ELEMS = 1 << 23


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack(
        [a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
         a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
         a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _normalize(v):
    length = torch.sqrt(torch.clamp(_dot(v, v), min=0.0))
    return v * (1.0 / torch.clamp(length, min=1e-8))[..., None]


def _lum(rgb):
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def _onb(n):
    """Branchless orthonormal basis about unit ``n`` (Duff et al. 2017)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + n[..., 2])
    bv = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * bv,
                     -s * n[..., 0]], dim=-1)
    b = torch.stack([bv, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, b


def _cosine_dir(n, u1, u2):
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    t, b = _onb(n)
    return ((r * torch.cos(phi))[..., None] * t
            + (r * torch.sin(phi))[..., None] * b + z[..., None] * n)


@dataclass
class Geometry:
    """Triangles on the device: the big ones (walls) tested by every ray,
    the rest in groups of ``group`` with a box each."""

    big_v0: torch.Tensor
    big_e1: torch.Tensor
    big_e2: torch.Tensor
    big_id: torch.Tensor
    grp_v0: torch.Tensor      # (C, G, 3)
    grp_e1: torch.Tensor
    grp_e2: torch.Tensor
    grp_id: torch.Tensor      # (C, G) row id, -1 padding
    box_min: torch.Tensor     # (C, 3)
    box_max: torch.Tensor
    normal: torch.Tensor      # (T, 3) unit geometric normal
    mat: torch.Tensor         # (T,) material id
    dtype: torch.dtype

    def closest(self, o, d, t_max):
        return closest(self, o, d, t_max)

    def surface(self, row):
        """(unit geometric normal, material id) of hit rows (>= 0)."""
        return self.normal[row], self.mat[row]


def _morton(p):
    q = np.clip((p * 1023.0).astype(np.int64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def prepare(v0, e1, e2, mat, device, dtype=torch.float32, group=128,
            big_ratio=64.0):
    """Geometry of float32 triangle arrays (v0, e1, e2: (T, 3); mat: (T,)).
    Triangles whose box diagonal passes ``big_ratio`` times the median
    are tested by every ray, outside the groups."""
    v0, e1, e2 = (np.asarray(x, np.float32) for x in (v0, e1, e2))
    corners = np.stack([v0, v0 + e1, v0 + e2], axis=1)
    lo, hi = corners.min(axis=1), corners.max(axis=1)
    diag = np.linalg.norm(hi - lo, axis=1)
    big = diag > big_ratio * np.median(diag)
    n = np.cross(e1, e2)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    normal = (n / np.maximum(norm, 1e-20)).astype(np.float32)

    small = np.nonzero(~big)[0]
    cen = (lo[small] + hi[small]) * 0.5
    span = np.maximum(cen.max(axis=0) - cen.min(axis=0), 1e-12)
    small = small[np.argsort(_morton((cen - cen.min(axis=0)) / span),
                             kind="stable")]
    c = max(1, -(-small.size // group))
    ids = np.full(c * group, -1, np.int64)
    ids[:small.size] = small
    ids = ids.reshape(c, group)
    safe = np.maximum(ids, 0)
    pad = ids < 0
    g_lo = np.where(pad[..., None], np.inf, lo[safe]).min(axis=1)
    g_hi = np.where(pad[..., None], -np.inf, hi[safe]).max(axis=1)
    # Padding is a degenerate triangle far away: det 0, never hit.
    g_v0 = np.where(pad[..., None], np.float32(3e30), v0[safe])
    g_e1 = np.where(pad[..., None], 0.0, e1[safe]).astype(np.float32)
    g_e2 = np.where(pad[..., None], 0.0, e2[safe]).astype(np.float32)

    def dev(x, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(x), device=device).to(dt)

    bi = np.nonzero(big)[0]
    return Geometry(
        big_v0=dev(v0[bi]), big_e1=dev(e1[bi]), big_e2=dev(e2[bi]),
        big_id=dev(bi, torch.int64),
        grp_v0=dev(g_v0), grp_e1=dev(g_e1), grp_e2=dev(g_e2),
        grp_id=dev(ids, torch.int64),
        box_min=dev(g_lo), box_max=dev(g_hi), normal=dev(normal),
        mat=dev(np.asarray(mat), torch.int64), dtype=dtype)


def _mt(o, d, v0, e1, e2):
    """Moller-Trumbore t (inf on a miss or at t <= T_MIN)."""
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    small = torch.abs(det) < 1e-12
    inv = 1.0 / torch.where(small, 1e-12, det)
    tvec = o - v0
    u = _dot(tvec, pvec) * inv
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv
    t = _dot(e2, qvec) * inv
    ok = ~small & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN)
    return torch.where(ok, t, INF)


def _key(t, idx):
    """Order-preserving int64 key of (t >= 0, row id): the nearest t,
    then the lowest row."""
    bits = t.to(torch.float32).view(torch.int32).to(torch.int64)
    return (bits << 22) | idx


def closest(geo: Geometry, o, d, t_max):
    """(t, row) of the nearest hit in (T_MIN, t_max) per ray; t = inf and
    row = -1 on a miss. ``t_max``: (R,)."""
    r = o.shape[0]
    dev = o.device
    t_big = _mt(o[:, None], d[:, None], geo.big_v0[None], geo.big_e1[None],
                geo.big_e2[None])
    tb, ib = t_big.min(dim=1) if t_big.shape[1] else (
        torch.full((r,), INF, dtype=o.dtype, device=dev),
        torch.zeros(r, dtype=torch.int64, device=dev))
    tb = torch.where(tb < t_max, tb, INF)
    best = _key(tb, torch.where(torch.isfinite(tb), geo.big_id[ib]
                                if geo.big_id.numel() else 0, 0))
    safe_d = torch.where(torch.abs(d) < 1e-12,
                         torch.where(d >= 0, 1e-12, -1e-12).to(d.dtype), d)
    inv_d = 1.0 / safe_d
    cap = torch.minimum(tb, t_max)
    n_box = geo.box_min.shape[0]
    rb = max(1, BLOCK_ELEMS // max(n_box, 1))
    group = geo.grp_v0.shape[1]
    for r0 in range(0, r, rb):
        sl = slice(r0, min(r, r0 + rb))
        t0 = (geo.box_min[None] - o[sl, None]) * inv_d[sl, None]
        t1 = (geo.box_max[None] - o[sl, None]) * inv_d[sl, None]
        tn = torch.minimum(t0, t1).amax(dim=-1)
        tf = torch.maximum(t0, t1).amin(dim=-1)
        hit = (tn <= tf) & (tf > T_MIN) & (tn < cap[sl, None])
        pairs = torch.nonzero(hit)
        pb = max(1, BLOCK_ELEMS // group)
        for p0 in range(0, pairs.shape[0], pb):
            ray = pairs[p0:p0 + pb, 0] + r0
            grp = pairs[p0:p0 + pb, 1]
            t = _mt(o[ray, None], d[ray, None], geo.grp_v0[grp],
                    geo.grp_e1[grp], geo.grp_e2[grp])
            tm, lane = t.min(dim=1)
            tm = torch.where(tm < t_max[ray], tm, INF)
            row = geo.grp_id[grp, lane]
            key = _key(tm, torch.where(torch.isfinite(tm), row, 0))
            best.scatter_reduce_(0, ray, key, reduce="amin")
    bits = (best >> 22).to(torch.int32)
    t = bits.view(torch.float32)
    row = torch.where(torch.isfinite(t), best & ((1 << 22) - 1), -1)
    return t.to(o.dtype), row


@dataclass
class Lights:
    """The emissive triangles in one pick order, as the port's light table
    holds them: corners and edges, unit normals, radiance, the inclusive
    power CDF and the total power."""

    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    normal: torch.Tensor
    emit: torch.Tensor
    cum: torch.Tensor
    total_power: float


def light_orders(v0, e1, e2, mat, materials, device, dtype=torch.float32):
    """One ``Lights`` for every order of the emissive triangles. The
    program picks a light by its power CDF over the rows in its own stored
    order, which the scene does not fix; with two rows there are two
    orders, and the check keeps the one the program's images follow."""
    v0, e1, e2 = (np.asarray(x, np.float32) for x in (v0, e1, e2))
    emits = np.array([m[2] for m in materials], np.float32)
    kinds = np.array([m[0] for m in materials])
    rows = np.nonzero(kinds[np.asarray(mat)] == "emissive")[0]
    if rows.size > 3:
        raise ValueError("more than 3 emissive triangles: too many orders")
    out = []
    for order in permutations(rows):
        order = np.array(order, np.int64)
        lv0 = v0[order]
        le1 = (v0[order] + e1[order]) - lv0
        le2 = (v0[order] + e2[order]) - lv0
        n = np.cross(le1, le2)
        norm = np.linalg.norm(n, axis=1)
        area = 0.5 * norm
        lemit = emits[np.asarray(mat)[order]]
        lum = (0.2126 * lemit[:, 0] + 0.7152 * lemit[:, 1]
               + 0.0722 * lemit[:, 2]).astype(np.float64)
        power = lum * area.astype(np.float64)
        total = float(power.sum())

        def dev(x):
            return torch.as_tensor(np.asarray(x, np.float32),
                                   device=device).to(dtype)

        out.append(Lights(
            v0=dev(lv0), e1=dev(le1), e2=dev(le2),
            normal=dev(n / np.maximum(norm[:, None], 1e-20)), emit=dev(lemit),
            cum=dev(np.cumsum(power) / total),
            total_power=float(np.float32(total))))
    return out


def camera_frame(camera: dict, aspect: float):
    """Pinhole frame (origin, lower_left, horizontal, vertical) as float32
    numpy, computed as the port's host-side camera set-up computes it."""
    position = np.asarray(camera["position"], np.float32)
    look_at = np.asarray(camera["look_at"], np.float32)
    up = np.asarray(camera["up"], np.float32)
    half_h = np.tan(np.radians(camera["vfov_degrees"]) / 2.0)
    half_w = aspect * half_h
    w = position - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    lower_left = position - half_w * u - half_h * v - w
    return (position, lower_left.astype(np.float32),
            (2.0 * half_w * u).astype(np.float32),
            (2.0 * half_h * v).astype(np.float32))


def render(geo, lights: Lights, materials, camera: dict,
           width: int, height: int, max_depth: int, seed: int, pixel,
           sample):
    """Radiance (R, 3) float32 of the paths (``pixel``, ``sample``): flat
    row-major pixel ids and global sample ids, (R,) int64 tensors.
    ``geo`` gives ``dtype``, ``closest(o, d, t_max) -> (t, row)`` (row -1
    on a miss) and ``surface(row) -> (unit normal, material id)``."""
    dt = geo.dtype
    dev = pixel.device
    r = pixel.shape[0]
    albedo = torch.tensor([m[1] for m in materials], dtype=torch.float32,
                          device=dev).to(dt)
    emit_tab = torch.tensor([m[2] for m in materials], dtype=torch.float32,
                            device=dev).to(dt)
    diffuse = torch.tensor([m[0] == "lambertian" for m in materials],
                           device=dev)
    frame = [torch.as_tensor(x, device=dev).to(dt)
             for x in camera_frame(camera, width / height)]
    origin0, lower_left, horizontal, vertical = frame

    x = (pixel % width).to(torch.float32)
    y = (height - 1 - pixel // width).to(torch.float32)
    keys = rs.pixel_sample_key(seed, pixel, sample)
    j0, j1 = rs.ld_pair(seed, pixel, sample, rs.STREAM_PIXEL_JITTER)
    s = ((x + j0) / width).to(dt)
    t = ((y + j1) / height).to(dt)
    target = lower_left + s[:, None] * horizontal + t[:, None] * vertical
    o = origin0.expand(r, 3)
    d = _normalize(target - o)
    ld_nee = torch.stack(
        [rs.ld_scalar(seed, pixel, sample, rs.STREAM_NEE),
         *rs.ld_pair(seed, pixel, sample, rs.STREAM_NEE)], dim=1).to(dt)
    ld_scatter = torch.stack(
        rs.ld_pair(seed, pixel, sample, rs.STREAM_SCATTER), dim=1).to(dt)

    radiance = torch.zeros((r, 3), dtype=dt, device=dev)
    through = torch.ones((r, 3), dtype=dt, device=dev)
    active = torch.ones(r, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(r, dtype=dt, device=dev)
    prev_nee = torch.zeros(r, dtype=torch.bool, device=dev)
    total_power = lights.total_power
    n_lights = lights.cum.shape[0]
    for depth in range(max_depth):
        t_cap = torch.where(active, 3.0e38, 0.0).to(dt)
        t_hit, row = geo.closest(o, d, t_cap)
        valid = active & (row >= 0)
        n_geo, row_mat = geo.surface(torch.clamp(row, min=0))
        front = _dot(d, n_geo) < 0.0
        normal = torch.where(front[:, None], n_geo, -n_geo)
        t_hit = torch.where(valid, t_hit, 0.0)
        pos = o + t_hit[:, None] * d
        mat = torch.where(valid, row_mat, 0)
        alb, emit = albedo[mat], emit_tab[mat]
        is_diffuse = diffuse[mat]

        # Emission, MIS-weighted against the previous vertex's NEE.
        cos_l = torch.abs(_dot(d, normal))
        pdf_l = t_hit * t_hit * _lum(emit) / (cos_l * total_power + 1e-20)
        w = prev_pdf ** 2 / (prev_pdf ** 2 + pdf_l ** 2 + 1e-30)
        is_light = valid & (emit.amax(dim=-1) > 0.0)
        emit_w = torch.where(prev_nee & is_light, w, 1.0)
        radiance = radiance + torch.where(
            valid[:, None], through * emit * emit_w[:, None], 0.0)

        kd = rs.fold_in(keys, depth)
        if depth == 0:
            ul, us = ld_nee, ld_scatter
        else:
            ul = rs.uniform(rs.fold_in(kd, rs.STREAM_NEE), 3).to(dt)
            us = rs.uniform(rs.fold_in(kd, rs.STREAM_SCATTER), 2).to(dt)

        # Next-event estimation: power pick, area-uniform point.
        idx = torch.clamp((ul[:, 0:1] > lights.cum[None]).sum(dim=1), 0,
                          n_lights - 1)
        su = torch.sqrt(torch.clamp(ul[:, 1:2], min=1e-12))
        a, b = 1.0 - su, su * ul[:, 2:3]
        lp = lights.v0[idx] + a * lights.e1[idx] + b * lights.e2[idx]
        ln, lemit = lights.normal[idx], lights.emit[idx]
        llum = _lum(lemit)
        wi_vec = lp - pos
        dist2 = _dot(wi_vec, wi_vec)
        dist = torch.sqrt(torch.clamp(dist2, min=1e-12))
        wi = wi_vec / dist[:, None]
        pdf_sa = dist2 * llum / (torch.abs(_dot(ln, wi_vec / dist[:, None]))
                                 * total_power + 1e-20)
        cos_s = _dot(normal, wi)
        cos_ln = torch.abs(_dot(ln, wi))
        cand = (valid & is_diffuse & (cos_s > 1e-6) & (cos_ln > 1e-6)
                & (dist2 > 1e-8))
        t_shadow = torch.where(cand, dist * (1.0 - 1e-3), 0.0)
        t_occ, _ = geo.closest(pos, wi, t_shadow)
        vis = cand & ~(t_occ < t_shadow)
        pdf_b = cos_s * INV_PI
        pdf_ln = dist2 * llum / (cos_ln * total_power + 1e-20)
        w_l = pdf_ln ** 2 / (pdf_ln ** 2 + pdf_b ** 2 + 1e-30)
        scale = cos_s / torch.clamp(pdf_sa, min=1e-20) * w_l
        contrib = through * (alb * INV_PI) * lemit * scale[:, None]
        radiance = radiance + torch.where(vis[:, None], contrib, 0.0)

        # Cosine-weighted scatter; emitters end the path.
        d_out = _cosine_dir(normal, us[:, 0], us[:, 1])
        pdf = torch.clamp(_dot(normal, d_out), min=1e-6) * INV_PI
        through = through * torch.where(valid[:, None], alb, 1.0)
        active = valid & is_diffuse
        o = pos
        d = torch.where(active[:, None], d_out, d)
        prev_pdf = torch.clamp(torch.where(is_diffuse, pdf, 0.0), min=1e-6)
        prev_nee = valid & is_diffuse
    return radiance.to(torch.float32)
