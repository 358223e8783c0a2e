"""Plain reference intersection with the port's float32 triangle
arithmetic: the same culling, groups, placements and hit keys as
``pathtrace.Geometry`` and ``instanced.Instanced``, but each triangle is
tested by the Woop unit-triangle test, each placement moves a ray into
object space and each hit normal comes back to world space by the
formulas, term orders and float32 roundings that the JAX package's
``_pair_eval`` and ``_ray_to_object`` define (and the port keeps bit for
bit):

* a triangle's rows M = [e1 | e2 | e1 x e2]^-1 inverted in float64 and
  rounded, b = -M v0 in float32, its unit normal e1 x e2 in float64,
  rounded; a degenerate one never hits;
* o' = tr + L0 o0 + L1 o1 + L2 o2 and d' = L0 d0 + L1 d1 + L2 d2, added
  left to right;
* per component op = b + o0 M0 + o1 M1 + o2 M2, dp = d0 M0 + d1 M1 +
  d2 M2; t = -op_w / dp_w, u = op_u + t dp_u, v = op_v + t dp_v; a hit
  where u, v >= 0, u + v <= 1 and t > ``T_MIN``;
* the normal L^T n, always renormalised by the reciprocal square root.

Why: two float32 tracers whose arithmetic differs part where a ray passes
within rounding of a facet edge, and that rounding grows with the
coordinates. In a scene of a few units (the Cornell cells) Moller-Trumbore
and the Woop test part on a few paths in a million; in the instanced field
(coordinates near 50, first hits at t near 80, facets 0.0085 across) the
first hits' t differ in the last bits on about 60% of the camera rays, and
about one path in 4,000 ends elsewhere: more pixels than ``off_share``
allows at a few hundred samples. What decides which triangles a ray
tests, in what order, and what a path does at its hits stays the
reference's own."""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ptbench.reference import instanced
from ptbench.reference import pathtrace as pt

# The always-miss rows of padding: M = 0, b = (-1, -1, 1), so u = -1.
MISS = np.array([0.0] * 9 + [-1.0, -1.0, 1.0], np.float32)


def woop_rows(v0, e1, e2):
    """(T, 12) float32 [M_u, M_v, M_w, b] rows and (T, 3) float32 unit
    normals of float32 triangle arrays."""
    v0 = np.asarray(v0, np.float32)
    tv0, te1, te2 = (np.asarray(x, np.float32).astype(np.float64)
                     for x in (v0, e1, e2))
    n_geo = np.cross(te1, te2)
    norm = np.linalg.norm(n_geo, axis=-1, keepdims=True)
    ok = norm[..., 0] > 1e-20
    n_unit = np.where(ok[..., None], n_geo / np.maximum(norm, 1e-20), 0.0)
    basis = np.stack([te1, te2, n_geo], axis=-1)
    dead = (np.abs(np.linalg.det(basis)) < 1e-30) | ~ok
    basis[dead] = np.eye(3)
    m = np.linalg.inv(basis).astype(np.float32)
    b = -np.einsum("ckij,ckj->cki", m[None], v0[None])[0]
    rows = np.concatenate([m.reshape(-1, 9), b], axis=1)
    rows[dead] = MISS
    normal = np.where(dead[:, None], 0.0, n_unit).astype(np.float32)
    return rows, normal


def _woop_t(o, d, w):
    """t of rays (o, d: (..., 3)) against Woop rows w (..., 12), inf on a
    miss or at t <= ``T_MIN``."""
    op, dp = [], []
    for c in range(3):
        p = w[..., 9 + c] + o[..., 0] * w[..., 3 * c]
        p = p + o[..., 1] * w[..., 3 * c + 1]
        op.append(p + o[..., 2] * w[..., 3 * c + 2])
        q = d[..., 0] * w[..., 3 * c]
        q = q + d[..., 1] * w[..., 3 * c + 1]
        dp.append(q + d[..., 2] * w[..., 3 * c + 2])
    dw = torch.where(torch.abs(dp[2]) < 1e-30, 1e-30, dp[2]).to(o.dtype)
    t = -op[2] / dw
    u = op[0] + t * dp[0]
    v = op[1] + t * dp[1]
    ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > pt.T_MIN)
    return torch.where(ok, t, pt.INF)


def _unit(n):
    """n renormalised by the reciprocal square root of its squared length
    (summed x, y, z in order)."""
    len2 = n[..., 0] * n[..., 0] + n[..., 1] * n[..., 1] + n[..., 2] * n[..., 2]
    return n * torch.rsqrt(torch.clamp(len2, min=1e-30))[..., None]


def _rows_of(ids, table, device, dtype):
    """Rows of ``table`` for the ids (-1: the always-miss rows)."""
    ids = np.asarray(ids)
    out = np.where((ids >= 0)[..., None], table[np.maximum(ids, 0)], MISS)
    return torch.as_tensor(out, device=device).to(dtype)


@dataclass
class Geometry(pt.Geometry):
    """``pathtrace.Geometry`` tested by the Woop rows of its triangles."""

    big_w: torch.Tensor = None     # (B, 12)
    grp_w: torch.Tensor = None     # (C, G, 12)

    def closest(self, o, d, t_max):
        """(t, row) as ``pathtrace.closest``, by the Woop test."""
        r = o.shape[0]
        dev = o.device
        t_big = _woop_t(o[:, None], d[:, None], self.big_w[None])
        tb, ib = t_big.min(dim=1) if t_big.shape[1] else (
            torch.full((r,), pt.INF, dtype=o.dtype, device=dev),
            torch.zeros(r, dtype=torch.int64, device=dev))
        tb = torch.where(tb < t_max, tb, pt.INF)
        best = pt._key(tb, torch.where(torch.isfinite(tb), self.big_id[ib]
                                       if self.big_id.numel() else 0, 0))
        inv_d = instanced._safe_inv(d)
        cap = torch.minimum(tb, t_max)
        n_box = self.box_min.shape[0]
        rb = max(1, pt.BLOCK_ELEMS // max(n_box, 1))
        group = self.grp_w.shape[1]
        for r0 in range(0, r, rb):
            sl = slice(r0, min(r, r0 + rb))
            t0 = (self.box_min[None] - o[sl, None]) * inv_d[sl, None]
            t1 = (self.box_max[None] - o[sl, None]) * inv_d[sl, None]
            tn = torch.minimum(t0, t1).amax(dim=-1)
            tf = torch.maximum(t0, t1).amin(dim=-1)
            hit = (tn <= tf) & (tf > pt.T_MIN) & (tn < cap[sl, None])
            pairs = torch.nonzero(hit)
            pb = max(1, pt.BLOCK_ELEMS // group)
            for p0 in range(0, pairs.shape[0], pb):
                ray = pairs[p0:p0 + pb, 0] + r0
                grp = pairs[p0:p0 + pb, 1]
                t = _woop_t(o[ray, None], d[ray, None], self.grp_w[grp])
                tm, lane = t.min(dim=1)
                tm = torch.where(tm < t_max[ray], tm, pt.INF)
                row = self.grp_id[grp, lane]
                key = pt._key(tm, torch.where(torch.isfinite(tm), row, 0))
                best.scatter_reduce_(0, ray, key, reduce="amin")
        t = (best >> 22).to(torch.int32).view(torch.float32)
        row = torch.where(torch.isfinite(t), best & ((1 << 22) - 1), -1)
        return t.to(o.dtype), row

    def surface(self, row):
        """(unit normal, material id): the rounded float64 normal,
        renormalised as a placement's is (an identity one here)."""
        return _unit(self.normal[row]), self.mat[row]


@dataclass
class Instanced(instanced.Instanced):
    """``instanced.Instanced`` with the port's arithmetic (see the
    module's note); ``base`` is a ``Geometry`` of this module."""

    grp_w: torch.Tensor = None     # (C, G, 12)

    def _enter(self, o, d, t_max, r, p, best):
        """``instanced.Instanced._enter`` with o' = tr + L o and the Woop
        test."""
        lin, tr, v = self.lin[p], self.tr[p], o[r]
        oo = torch.stack([tr[:, i] + lin[:, i, 0] * v[:, 0]
                          + lin[:, i, 1] * v[:, 1] + lin[:, i, 2] * v[:, 2]
                          for i in range(3)], dim=1)
        dd = instanced._affine(lin, None, d[r])
        inv = instanced._safe_inv(dd)
        proto = self.proto_of[p]
        cap = instanced._key_t(best[r]).to(o.dtype)
        k1, run, _ = instanced._pierced(oo, inv, cap, self.proto_runs[proto],
                                        self.run_min, self.run_max)
        if not k1.numel():
            return
        i2, grp, _ = instanced._pierced(oo[k1], inv[k1], cap[k1],
                                        self.run_members[run], self.grp_min,
                                        self.grp_max)
        k = k1[i2]
        step = max(1, pt.BLOCK_ELEMS // self.grp_w.shape[1])
        for a in range(0, k.shape[0], step):
            kk, gg = k[a:a + step], grp[a:a + step]
            t = _woop_t(oo[kk, None], dd[kk, None], self.grp_w[gg])
            tm, lane = t.min(dim=1)
            rr = r[kk]
            tm = torch.where(tm < t_max[rr], tm, pt.INF)
            local = self.grp_tri[gg, lane] - self.proto_first[proto[kk]]
            row = torch.where(torch.isfinite(tm),
                              self.row0[p[kk]] + local, 0)
            best.scatter_reduce_(0, rr, instanced._key(tm, row),
                                 reduce="amin")

    def surface(self, row):
        """(unit world normal, material id): L^T n, always renormalised."""
        n_base = self.base.mat.shape[0]
        nb, mb = self.base.surface(torch.clamp(row, max=n_base - 1))
        p = torch.clamp(torch.searchsorted(self.row0, row, right=True) - 1,
                        min=0)
        tri = self.proto_first[self.proto_of[p]] + torch.clamp(
            row - self.row0[p], min=0)
        tri = torch.clamp(tri, max=self.tri_mat.shape[0] - 1)
        nw = _unit(instanced._affine(self.lin[p].transpose(1, 2), None,
                                     self.tri_normal[tri]))
        im = self.imat[p]
        mat = torch.where(im >= 0, im, self.tri_mat[tri])
        is_base = row < n_base
        return (torch.where(is_base[:, None], nb, nw),
                torch.where(is_base, mb, mat))


def prepare(base, protos, placements, device, dtype=torch.float32):
    """``instanced.prepare`` of the same arguments, tested and shaded with
    the port's arithmetic."""
    geo = instanced.prepare(base, protos, placements, device, dtype)
    b_rows, b_normal = woop_rows(*base[:3])
    g = geo.base
    base_geo = Geometry(
        **{f.name: getattr(g, f.name) for f in fields(pt.Geometry)},
        big_w=_rows_of(g.big_id.cpu().numpy(), b_rows, device, dtype),
        grp_w=_rows_of(g.grp_id.cpu().numpy(), b_rows, device, dtype))
    base_geo.normal = torch.as_tensor(b_normal, device=device).to(dtype)
    p_rows, p_normal = zip(*(woop_rows(*tris[:3]) for tris in protos))
    p_rows, p_normal = np.concatenate(p_rows), np.concatenate(p_normal)
    kept = {f.name: getattr(geo, f.name) for f in fields(instanced.Instanced)}
    kept.update(base=base_geo,
                tri_normal=torch.as_tensor(p_normal, device=device).to(dtype))
    return Instanced(**kept, grp_w=_rows_of(geo.grp_tri.cpu().numpy(),
                                            p_rows, device, dtype))
