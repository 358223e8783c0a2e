"""Plain reference intersection of instanced scenes: placements of
prototypes, traced placement by placement in each prototype's object
space, beside the flat base triangles (ground and emitters). Plain torch;
it shares nothing with the port's trees, clusters, pages or instance
sets.

* Base triangles: a ``pathtrace.Geometry``, rows 0 .. B-1.
* Prototypes, in object space: each a ``pathtrace.Geometry`` of
  Morton-ordered groups of 128 triangles (none outside the groups), its
  groups in runs of ``SUPER`` under one box more.
* Placements: a prototype, a 3x4 object-to-world affine (float64) and a
  material override (-1 keeps the triangle's). A placement's triangles
  take the row ids after the base rows and the placements before it.

A ray culls placements by their world boxes (the prototype's box corners
through the affine in float64, widened for rounding, in runs of
``SUPER`` under one box, Morton-ordered), then enters the placements it
pierces nearest first, in rounds of doubling rank, skipping a placement
whose box it enters behind its nearest hit so far. In a placement it runs
in object space, o' = L o + tr, d' = L d, with L and tr the inverse
affine (inverted in float64, stored in ``dtype``); d' is not normalised,
so t stays the world t. Möller-Trumbore on the groups it pierces; the
nearest hit in (``T_MIN``, t_max) by (t, then the lowest row id). The
world normal is L^T n_obj, normalised where L is not a rotation (a
rotation keeps a unit normal unit, so an identity placement gives the
flat geometry's normal bit for bit). Lights stay among the base
triangles. Work goes in blocks of at most ``pathtrace.BLOCK_ELEMS``
(rays x boxes, pairs x groups, pairs x triangles)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ptbench.reference import pathtrace as pt

# Boxes under one box more: placements a run, prototype groups a run.
SUPER = 64
ROW_LIMIT = 1 << 32


def _key(t, row):
    """Order-preserving int64 key of (t >= 0, row < 2^32): the nearest t,
    then the lowest row."""
    return (t.to(torch.float32).view(torch.int32).to(torch.int64) << 32) | row


def _key_t(key):
    return (key >> 32).to(torch.int32).view(torch.float32)


def _safe_inv(d):
    return 1.0 / torch.where(torch.abs(d) < 1e-12,
                             torch.where(d >= 0, 1e-12, -1e-12).to(d.dtype),
                             d)


def _pierced(o, inv_d, cap, cand, box_min, box_max):
    """(ray, box, entry t) of the boxes ``cand[i]`` (ids into ``box_min``
    and ``box_max``, -1 padding) that ray i pierces before ``cap[i]``;
    ``cand`` (n, W) int64, perhaps an expanded view."""
    n, width = cand.shape
    rays, boxes, entry = [], [], []
    step = max(1, pt.BLOCK_ELEMS // max(width, 1))
    for a in range(0, n, step):
        sl = slice(a, min(n, a + step))
        c = cand[sl]
        cs = torch.clamp(c, min=0)
        t0 = (box_min[cs] - o[sl, None]) * inv_d[sl, None]
        t1 = (box_max[cs] - o[sl, None]) * inv_d[sl, None]
        tn = torch.minimum(t0, t1).amax(dim=-1)
        tf = torch.maximum(t0, t1).amin(dim=-1)
        hit = (c >= 0) & (tn <= tf) & (tf > pt.T_MIN) & (tn < cap[sl, None])
        i, j = torch.nonzero(hit).unbind(1)
        rays.append(i + a)
        boxes.append(c[i, j])
        entry.append(tn[i, j])
    return torch.cat(rays), torch.cat(boxes), torch.cat(entry)


def _affine(lin, tr, v):
    """lin v (+ tr): (K, 3, 3), (K, 3) or None, (K, 3)."""
    out = torch.stack([lin[:, i, 0] * v[:, 0] + lin[:, i, 1] * v[:, 1]
                       + lin[:, i, 2] * v[:, 2] for i in range(3)], dim=1)
    return out if tr is None else out + tr


def _runs(box_min, box_max, ids):
    """Boxes ``ids`` (already in Morton order) in runs of ``SUPER`` under
    one box each: (S, SUPER) member ids (-1 padding) and (S, 3) boxes."""
    s = max(1, -(-ids.shape[0] // SUPER))
    members = torch.full((s * SUPER,), -1, dtype=torch.int64,
                         device=ids.device)
    members[:ids.shape[0]] = ids
    members = members.reshape(s, SUPER)
    pad = (members < 0)[..., None]
    safe = torch.clamp(members, min=0)
    lo = torch.where(pad, torch.inf, box_min[safe]).amin(dim=1)
    hi = torch.where(pad, -torch.inf, box_max[safe]).amax(dim=1)
    return members, lo, hi


@dataclass
class Instanced:
    """Base triangles, prototypes and placements on the device."""

    base: pt.Geometry
    # The prototypes' groups, one prototype after another.
    grp_v0: torch.Tensor       # (C, G, 3)
    grp_e1: torch.Tensor
    grp_e2: torch.Tensor
    grp_tri: torch.Tensor      # (C, G) row of the prototypes' table, -1
    grp_min: torch.Tensor      # (C, 3)
    grp_max: torch.Tensor
    run_members: torch.Tensor  # (S, SUPER) group ids, -1 padding
    run_min: torch.Tensor      # (S, 3)
    run_max: torch.Tensor
    proto_runs: torch.Tensor   # (NP, Smax) run ids, -1 padding
    proto_first: torch.Tensor  # (NP,) first row of each in the table
    tri_normal: torch.Tensor   # (sum T_p, 3) object-space unit normals
    tri_mat: torch.Tensor      # (sum T_p,)
    # Placements.
    proto_of: torch.Tensor     # (P,)
    lin: torch.Tensor          # (P, 3, 3) world -> object
    tr: torch.Tensor           # (P, 3)
    rigid: torch.Tensor        # (P,) L is a rotation
    imat: torch.Tensor         # (P,) override, -1 keeps
    row0: torch.Tensor         # (P,) first row id
    pl_min: torch.Tensor       # (P, 3) widened world boxes
    pl_max: torch.Tensor
    top_members: torch.Tensor  # (Q, SUPER) placement ids, -1 padding
    top_min: torch.Tensor      # (Q, 3)
    top_max: torch.Tensor
    dtype: torch.dtype

    def closest(self, o, d, t_max):
        """(t, row) of the nearest hit in (T_MIN, t_max) per ray; t = inf
        and row = -1 on a miss."""
        t_b, row_b = self.base.closest(o, d, t_max)
        best = _key(t_b, torch.clamp(row_b, min=0))
        live = torch.nonzero(t_max > pt.T_MIN).squeeze(1)
        if live.numel():
            self._placements(o, d, t_max, live, best)
        t = _key_t(best)
        row = torch.where(torch.isfinite(t), best & (ROW_LIMIT - 1), -1)
        return t.to(o.dtype), row

    def _placements(self, o, d, t_max, live, best):
        """Lowers the keys ``best`` of the rays ``live`` by their hits in
        the placements."""
        ol, dl = o[live], d[live]
        inv_d = _safe_inv(dl)
        cap = torch.minimum(_key_t(best[live]).to(o.dtype), t_max[live])
        n_top = self.top_members.shape[0]
        r1, q, _ = _pierced(ol, inv_d, cap, torch.arange(
            n_top, device=o.device).expand(live.shape[0], n_top),
            self.top_min, self.top_max)
        if not r1.numel():
            return
        i2, p, tn = _pierced(ol[r1], inv_d[r1], cap[r1], self.top_members[q],
                             self.pl_min, self.pl_max)
        if not i2.numel():
            return
        r = live[r1[i2]]
        # Each ray's placements nearest first, by rank.
        order = torch.argsort(tn.to(torch.float32), stable=True)
        order = order[torch.argsort(r[order], stable=True)]
        r, p, tn = r[order], p[order], tn[order]
        pos = torch.arange(r.shape[0], device=r.device)
        new = torch.ones_like(r, dtype=torch.bool)
        new[1:] = r[1:] != r[:-1]
        rank = pos - torch.cummax(torch.where(new, pos, 0), 0).values
        lo, hi, last = 0, 1, int(rank.max())
        while lo <= last:
            sel = ((rank >= lo) & (rank < hi)
                   & (tn.to(torch.float32) < _key_t(best[r])))
            k = torch.nonzero(sel).squeeze(1)
            if k.numel():
                self._enter(o, d, t_max, r[k], p[k], best)
            lo, hi = hi, 2 * hi

    def _enter(self, o, d, t_max, r, p, best):
        """Lowers ``best`` by the hits of the (ray ``r``, placement ``p``)
        pairs, in object space."""
        lin = self.lin[p]
        oo = _affine(lin, self.tr[p], o[r])
        dd = _affine(lin, None, d[r])
        inv = _safe_inv(dd)
        proto = self.proto_of[p]
        cap = _key_t(best[r]).to(o.dtype)
        k1, run, _ = _pierced(oo, inv, cap, self.proto_runs[proto],
                              self.run_min, self.run_max)
        if not k1.numel():
            return
        i2, grp, _ = _pierced(oo[k1], inv[k1], cap[k1],
                              self.run_members[run], self.grp_min,
                              self.grp_max)
        k = k1[i2]
        step = max(1, pt.BLOCK_ELEMS // self.grp_v0.shape[1])
        for a in range(0, k.shape[0], step):
            kk, gg = k[a:a + step], grp[a:a + step]
            t = pt._mt(oo[kk, None], dd[kk, None], self.grp_v0[gg],
                       self.grp_e1[gg], self.grp_e2[gg])
            tm, lane = t.min(dim=1)
            rr = r[kk]
            tm = torch.where(tm < t_max[rr], tm, pt.INF)
            local = self.grp_tri[gg, lane] - self.proto_first[proto[kk]]
            row = torch.where(torch.isfinite(tm),
                              self.row0[p[kk]] + local, 0)
            best.scatter_reduce_(0, rr, _key(tm, row), reduce="amin")

    def surface(self, row):
        """(unit world normal, material id) of hit rows (>= 0)."""
        n_base = self.base.mat.shape[0]
        nb, mb = self.base.surface(torch.clamp(row, max=n_base - 1))
        p = torch.clamp(torch.searchsorted(self.row0, row, right=True) - 1,
                        min=0)
        tri = self.proto_first[self.proto_of[p]] + torch.clamp(
            row - self.row0[p], min=0)
        tri = torch.clamp(tri, max=self.tri_mat.shape[0] - 1)
        nw = _affine(self.lin[p].transpose(1, 2), None, self.tri_normal[tri])
        nw = torch.where(self.rigid[p][:, None], nw, pt._normalize(nw))
        im = self.imat[p]
        mat = torch.where(im >= 0, im, self.tri_mat[tri])
        is_base = row < n_base
        return (torch.where(is_base[:, None], nb, nw),
                torch.where(is_base, mb, mat))


def prepare(base, protos, placements, device, dtype=torch.float32):
    """The ``Instanced`` geometry of ``base`` and ``protos`` (each
    (v0, e1, e2, mat): float32 (T, 3) arrays and (T,) material ids, the
    prototypes in object space) and ``placements`` ((prototype, (3, 4)
    float64 object-to-world affine, material override or -1) each)."""
    eps = torch.finfo(dtype).eps
    base_geo = pt.prepare(*base, device, dtype)
    geos = [pt.prepare(*tris, device, dtype, big_ratio=np.inf)
            for tris in protos]
    counts = [int(g.mat.shape[0]) for g in geos]
    proto_first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    first_grp = np.concatenate(
        [[0], np.cumsum([g.grp_v0.shape[0] for g in geos])[:-1]])

    def dev(x, dt):
        return torch.as_tensor(np.asarray(x), device=device).to(dt)

    grp_min = torch.cat([g.box_min for g in geos])
    grp_max = torch.cat([g.box_max for g in geos])
    runs = [_runs(grp_min, grp_max, torch.arange(
        f, f + g.grp_v0.shape[0], device=device))
        for f, g in zip(first_grp, geos)]
    n_runs = [m.shape[0] for m, _, _ in runs]
    proto_runs = torch.full((len(geos), max(n_runs)), -1, dtype=torch.int64,
                            device=device)
    first_run = 0
    for i, n in enumerate(n_runs):
        proto_runs[i, :n] = torch.arange(first_run, first_run + n,
                                         device=device)
        first_run += n

    # Placements: the inverse affines and world boxes, in float64.
    obj_lo, obj_hi = [], []
    for v0, e1, e2, _ in protos:
        v0 = np.asarray(v0, np.float32)
        corners = np.concatenate([v0, v0 + e1, v0 + e2]).astype(np.float64)
        obj_lo.append(corners.min(axis=0))
        obj_hi.append(corners.max(axis=0))
    proto_of, lins, trs, rigid, imat, pl_lo, pl_hi = [], [], [], [], [], [], []
    for proto, m, override in placements:
        m = np.asarray(m, np.float64)[:3]
        a, t = m[:, :3], m[:, 3]
        lin = np.linalg.inv(a)
        lins.append(lin)
        trs.append(-lin @ t)
        rigid.append(np.abs(lin.T @ lin - np.eye(3)).max() < 1e-9)
        proto_of.append(int(proto))
        imat.append(int(override))
        lo, hi = obj_lo[proto], obj_hi[proto]
        box = np.array([[x, y, z] for x in (lo[0], hi[0])
                        for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
        w = box @ a.T + t
        wlo, whi = w.min(axis=0), w.max(axis=0)
        margin = (whi - wlo) * 1e-6 + 4.0 * eps * np.maximum(
            np.abs(wlo), np.abs(whi)) + 1e-30
        pl_lo.append(wlo - margin)
        pl_hi.append(whi + margin)
    proto_of = np.asarray(proto_of, np.int64)
    sizes = np.asarray(counts, np.int64)[proto_of]
    row0 = base_geo.mat.shape[0] + np.concatenate(
        [[0], np.cumsum(sizes)[:-1]])
    if row0[-1] + sizes[-1] > ROW_LIMIT:
        raise ValueError("more than 2^32 rows: the hit key cannot hold them")
    pl_lo, pl_hi = np.asarray(pl_lo), np.asarray(pl_hi)
    cen = (pl_lo + pl_hi) * 0.5
    span = np.maximum(cen.max(axis=0) - cen.min(axis=0), 1e-12)
    morton = np.argsort(pt._morton((cen - cen.min(axis=0)) / span),
                        kind="stable")
    pl_min, pl_max = dev(pl_lo, dtype), dev(pl_hi, dtype)
    top_members, top_min, top_max = _runs(pl_min, pl_max,
                                          dev(morton, torch.int64))
    grp_tri = torch.cat([torch.where(g.grp_id >= 0, g.grp_id + int(f), -1)
                         for f, g in zip(proto_first, geos)])
    return Instanced(
        base=base_geo,
        grp_v0=torch.cat([g.grp_v0 for g in geos]),
        grp_e1=torch.cat([g.grp_e1 for g in geos]),
        grp_e2=torch.cat([g.grp_e2 for g in geos]),
        grp_tri=grp_tri, grp_min=grp_min, grp_max=grp_max,
        run_members=torch.cat([m for m, _, _ in runs]),
        run_min=torch.cat([lo for _, lo, _ in runs]),
        run_max=torch.cat([hi for _, _, hi in runs]),
        proto_runs=proto_runs,
        proto_first=dev(proto_first, torch.int64),
        tri_normal=torch.cat([g.normal for g in geos]),
        tri_mat=torch.cat([g.mat for g in geos]),
        proto_of=dev(proto_of, torch.int64),
        lin=dev(np.asarray(lins), dtype), tr=dev(np.asarray(trs), dtype),
        rigid=dev(np.asarray(rigid), torch.bool),
        imat=dev(np.asarray(imat, np.int64), torch.int64),
        row0=dev(row0, torch.int64), pl_min=pl_min, pl_max=pl_max,
        top_members=top_members, top_min=top_min, top_max=top_max,
        dtype=dtype)
