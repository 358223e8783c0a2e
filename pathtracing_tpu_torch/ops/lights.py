"""Area-light table + sampling for next-event estimation (the JAX
package's ``ops/lights.py``).

The table holds every emissive primitive — triangles and spheres — picked
with probability ∝ emitted power (luminance · area) by a power CDF; the
point within a picked triangle is area-uniform, so the per-area pdf at a
sample of light i is lum_i / total_power. Sphere rows are sampled by the
visible-cap cone (``sample_solid_angle``), with an area-uniform fallback
for a shading point inside the sphere. The pick index equals the JAX
package's: same CDF (built in float64 on the host, stored float32) and the
same Σ(u > cum) count.

Two selection modes, chosen by the table's size at build time. Small
tables index their columns by the pick. Tables of ``_GATHER_MIN`` rows or
more carry all sampler columns packed into one ``(L, 24)`` float32 table
and fetch ONE packed row per ray through ``ops.pgather.gather_rows`` (the
hand-written gather kernel on the card); their pick is
``torch.searchsorted(cum, u, right=False)``, which equals the count
exactly and avoids an (R, L) intermediate. Both modes copy rows exactly,
so they agree bit for bit.

Delta lights (point, spot, directional) are a table of their own,
``DeltaLights``: zero-extent emitters that a BSDF-sampled ray never hits,
so their estimator is pure next-event estimation with MIS weight 1, one
power-weighted pick per vertex (``sample_delta``).

Textured emitters: triangle rows of a textured emissive material carry
their corner uvs in edge form (``uv0``, ``uv_e1``, ``uv_e2``) and the atlas
id (``tex``; -1 on untextured rows and spheres), present only when some
emitter is textured. ``sample_solid_angle(with_uv=True)`` returns the
sampled point's uv and atlas id from the same draws as the point.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pathtracing_tpu_torch.ops import linalg, pgather

KIND_TRI = 0
KIND_SPHERE = 1

# Table size at which light selection switches to the searchsorted pick +
# one packed-row gather (the JAX package's threshold).
_GATHER_MIN = 192

# Column layout of ``LightTable.packed`` ((L, 24) f32, built only for
# gather-mode tables): slices for the vector columns, scalar indices for
# kind/tex (small ints, exact in f32). The uv columns are zero and tex is
# -1 in a table without a textured emitter.
_P_V0 = slice(0, 3)
_P_E1 = slice(3, 6)
_P_E2 = slice(6, 9)
_P_NORMAL = slice(9, 12)
_P_EMIT = slice(12, 15)
_P_KIND = 15
_P_UV0 = slice(16, 18)
_P_UVE1 = slice(18, 20)
_P_UVE2 = slice(20, 22)
_P_TEX = 22
_P_WIDTH = 24


class LightTable(NamedTuple):
    v0: torch.Tensor          # (L, 3) f32 triangle corner / sphere center
    e1: torch.Tensor          # (L, 3) f32 edge 1 / (radius, 0, 0)
    e2: torch.Tensor          # (L, 3) f32 edge 2 / zeros
    normal: torch.Tensor      # (L, 3) f32 unit geometric normal (tri only)
    emit: torch.Tensor        # (L, 3) f32 radiance
    # None when the table holds no sphere emitters: both samplers then
    # skip the cone / area-sphere math.
    kind: torch.Tensor        # (L,) i32 KIND_TRI | KIND_SPHERE, or None
    cum: torch.Tensor         # (L,)  f32 inclusive cumulative power fraction
    total_area: torch.Tensor  # () f32 — 0 means "no lights" (NEE no-op)
    total_power: torch.Tensor  # () f32 Σ luminance·area
    # Textured emission (triangle rows; None unless some emitter is
    # textured): corner uvs in edge form and the atlas id (-1: none). Light
    # selection stays ∝ the BASE power; the texel scales the contribution.
    uv0: torch.Tensor = None    # (L, 2) f32
    uv_e1: torch.Tensor = None  # (L, 2) f32
    uv_e2: torch.Tensor = None  # (L, 2) f32
    tex: torch.Tensor = None    # (L,) i32
    # Gather mode (L >= _GATHER_MIN only): all sampler columns packed into
    # one (L, _P_WIDTH) f32 table; None for small tables.
    packed: torch.Tensor = None


def build_light_table(v0, v1, v2, tri_mat, mat_type, mat_emit,
                      emissive_type: int, device, sph_center=None,
                      sph_radius=None, sph_mat=None, tri_uv=None,
                      tri_tex=None) -> LightTable:
    """Host-side (numpy) collection of the emissive triangles and spheres,
    uploaded to ``device``. ``tri_uv`` ((T, 3, 2)) are the corner uvs of
    every triangle and ``tri_tex`` ((T,)) each triangle's emission-texture
    id (-1: none); the textured columns attach only when some emitter has
    a texture."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    tri_mat = np.asarray(tri_mat)
    types = np.asarray(mat_type)
    emits = np.asarray(mat_emit, np.float32)[tri_mat]
    # Select by TYPE only: the checker material reuses the emit columns as
    # its second color and must not be classed as a light.
    sel = types[tri_mat] == emissive_type
    lv0, lv1, lv2 = v0[sel], v1[sel], v2[sel]
    lemit = emits[sel]
    luv = (None if tri_uv is None
           else np.asarray(tri_uv, np.float32)[sel])
    ltex = (None if tri_tex is None
            else np.asarray(tri_tex, np.int32)[sel])

    e1 = lv1 - lv0
    e2 = lv2 - lv0
    n = np.cross(e1, e2)
    norm = np.linalg.norm(n, axis=1)
    area = 0.5 * norm
    keep = area > 1e-12
    lv0, e1, e2, n, norm, area, lemit = (
        lv0[keep], e1[keep], e2[keep], n[keep], norm[keep], area[keep],
        lemit[keep],
    )
    if luv is not None:
        luv = luv[keep]
    if ltex is not None:
        ltex = ltex[keep]
    normal = (n / np.maximum(norm[:, None], 1e-20)).astype(np.float32)
    kind = np.zeros(lv0.shape[0], np.int32)
    has_sphere = False

    if sph_center is not None and len(sph_center):
        sc = np.asarray(sph_center, np.float32)
        sr = np.asarray(sph_radius, np.float32)
        sm = np.asarray(sph_mat)
        ssel = (types[sm] == emissive_type) & (sr > 1e-12)
        if ssel.any():
            has_sphere = True
            k = int(ssel.sum())
            lv0 = np.concatenate([lv0, sc[ssel]])
            se1 = np.zeros((k, 3), np.float32)
            se1[:, 0] = sr[ssel]
            e1 = np.concatenate([e1, se1])
            e2 = np.concatenate([e2, np.zeros((k, 3), np.float32)])
            normal = np.concatenate([normal, np.zeros((k, 3), np.float32)])
            lemit = np.concatenate(
                [lemit, np.asarray(mat_emit, np.float32)[sm[ssel]]]
            )
            area = np.concatenate(
                [area, 4.0 * np.pi * sr[ssel] * sr[ssel]]
            )
            kind = np.concatenate([kind, np.ones(k, np.int32)])
            if luv is not None:
                luv = np.concatenate([luv, np.zeros((k, 3, 2), np.float32)])
            if ltex is not None:
                ltex = np.concatenate([ltex, np.full(k, -1, np.int32)])

    # Selection weight = emitted power (luminance · area), f64 so the
    # all-equal-radiance case reduces to the area CDF bit-exactly.
    lum = (0.2126 * lemit[:, 0] + 0.7152 * lemit[:, 1]
           + 0.0722 * lemit[:, 2]).astype(np.float64)
    power = lum * area.astype(np.float64)
    total_power = float(power.sum())

    def dev(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    if lv0.shape[0] == 0 or total_power <= 0.0:
        zero3 = np.zeros((1, 3), np.float32)
        return LightTable(
            v0=dev(zero3), e1=dev(zero3), e2=dev(zero3), normal=dev(zero3),
            emit=dev(zero3), kind=None, cum=dev(np.ones(1, np.float32)),
            total_area=dev(np.float32(0.0)),
            total_power=dev(np.float32(0.0)),
        )
    cum = np.cumsum(power) / total_power
    uv_cols = {}
    if ltex is not None and (ltex >= 0).any():
        if luv is None:
            luv = np.zeros((lv0.shape[0], 3, 2), np.float32)
        uv_cols = {"uv0": luv[:, 0], "uv_e1": luv[:, 1] - luv[:, 0],
                   "uv_e2": luv[:, 2] - luv[:, 0], "tex": ltex}
    packed = None
    if lv0.shape[0] >= _GATHER_MIN:
        pk = np.zeros((lv0.shape[0], _P_WIDTH), np.float32)
        pk[:, _P_V0] = lv0
        pk[:, _P_E1] = e1
        pk[:, _P_E2] = e2
        pk[:, _P_NORMAL] = normal
        pk[:, _P_EMIT] = lemit
        pk[:, _P_KIND] = kind
        if uv_cols:
            pk[:, _P_UV0] = uv_cols["uv0"]
            pk[:, _P_UVE1] = uv_cols["uv_e1"]
            pk[:, _P_UVE2] = uv_cols["uv_e2"]
            pk[:, _P_TEX] = uv_cols["tex"]
        else:
            pk[:, _P_TEX] = -1.0
        packed = dev(pk)
    return LightTable(
        v0=dev(lv0), e1=dev(e1), e2=dev(e2), normal=dev(normal),
        emit=dev(lemit),
        kind=dev(kind, torch.int32) if has_sphere else None,
        cum=dev(cum.astype(np.float32)),
        total_area=dev(np.float32(float(area.sum()))),
        total_power=dev(np.float32(total_power)),
        packed=packed,
        **{k: dev(v, torch.int32 if k == "tex" else torch.float32)
           for k, v in uv_cols.items()},
    )


def pick(lights: LightTable, u0):
    """Power-CDF light pick, clipped to [0, L-1]: the count Σ(u0 > cum)
    for small tables, ``searchsorted`` (the identical index, with no
    (R, L) intermediate) for gather-mode tables."""
    n_lights = lights.cum.shape[0]
    if lights.packed is not None:
        idx = torch.searchsorted(lights.cum, u0.contiguous(), right=False)
    else:
        idx = torch.sum((u0[:, None] > lights.cum[None, :]).to(torch.int64),
                        dim=1)
    return torch.clamp(idx, 0, n_lights - 1)


def _pick_and_select(lights: LightTable, u0, with_uv: bool = False):
    """The picked rows' columns: (v0, e1, e2, normal, emit, kind), each
    (R, 3) f32 and kind (R,) i32 or None; with ``with_uv`` also (uv0,
    uv_e1, uv_e2, tex), (R, 2) f32 and (R,) i32. Gather-mode tables fetch
    ONE packed row per ray through ``pgather.gather_rows``; small tables
    index each column. Both are exact copies of the same rows."""
    idx = pick(lights, u0)
    if lights.packed is not None:
        rows = pgather.gather_rows(lights.packed, idx)        # (R, W)
        kind = None
        if lights.kind is not None:
            kind = rows[:, _P_KIND].to(torch.int32)
        out = (rows[:, _P_V0], rows[:, _P_E1], rows[:, _P_E2],
               rows[:, _P_NORMAL], rows[:, _P_EMIT], kind)
        if with_uv:
            out += (rows[:, _P_UV0], rows[:, _P_UVE1], rows[:, _P_UVE2],
                    rows[:, _P_TEX].to(torch.int32))
        return out
    kind = None if lights.kind is None else lights.kind[idx]
    out = (lights.v0[idx], lights.e1[idx], lights.e2[idx],
           lights.normal[idx], lights.emit[idx], kind)
    if with_uv:
        out += (lights.uv0[idx], lights.uv_e1[idx], lights.uv_e2[idx],
                lights.tex[idx])
    return out


def _barycentrics(u):
    """The sqrt-warped barycentric weights (a along e1, b along e2), each
    (R, 1), of an area-uniform point in a triangle."""
    su = torch.sqrt(torch.clamp(u[:, 1:2], min=1e-12))
    return 1.0 - su, su * u[:, 2:3]


def _triangle_point(v0, e1, e2, u):
    """Area-uniform point by sqrt-warped barycentrics."""
    a, b = _barycentrics(u)
    return v0 + a * e1 + b * e2


def _sphere_direction(u):
    """Area-uniform unit direction on the sphere and its azimuth."""
    z = 1.0 - 2.0 * u[:, 1]
    rxy = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * torch.pi * u[:, 2]
    dir_s = torch.stack([rxy * torch.cos(phi), rxy * torch.sin(phi), z],
                        dim=1)
    return dir_s, phi


def sample(lights: LightTable, u):
    """Power-weighted light pick, area-uniform point within it.

    u: (R, 3) uniforms. Returns (point (R,3), normal (R,3), emit (R,3));
    the per-area pdf at the point is ``luminance(emit) / total_power``."""
    v0, e1, e2, normal, emit, kind = _pick_and_select(lights, u[:, 0])
    p_tri = _triangle_point(v0, e1, e2, u)
    if kind is None:
        return p_tri, normal, emit
    is_sph = (kind == KIND_SPHERE)[:, None]
    # Sphere: v0 = center, e1.x = radius.
    dir_s, _ = _sphere_direction(u)
    p_sph = v0 + e1[:, 0:1] * dir_s
    return (torch.where(is_sph, p_sph, p_tri),
            torch.where(is_sph, dir_s, normal), emit)


def sample_solid_angle(lights: LightTable, u, origin, with_uv: bool = False):
    """NEE light sample with its per-solid-angle pdf.

    u: (R, 3) uniforms; origin: (R, 3) shading points. Returns
    (point (R,3), normal (R,3), emit (R,3), pdf_sa (R,)). Triangles and
    the inside-a-sphere fallback use the area law,
    pdf_sa = dist² · lum / (cosθ_l · total_power); a sphere seen from
    outside is sampled uniformly inside the cone it subtends, with
    pdf_sa = 2 · lum · r² / (total_power · (1 − cosθmax)) and
    1 − cosθmax computed as sin²θmax / (1 + cosθmax) so that small
    far-away lamps do not cancel to zero in f32.

    ``with_uv`` (tables with textured emitters): also the sampled point's
    uv (R, 2) and the row's atlas id (R,) (-1: untextured), from the same
    barycentric draws as the point, so the texel sits at the point."""
    sel = _pick_and_select(lights, u[:, 0], with_uv)
    v0, e1, e2, normal, emit, kind = sel[:6]
    a, b = _barycentrics(u)
    point = v0 + a * e1 + b * e2
    lum = linalg.luminance(emit)
    cone = None
    if kind is not None:
        is_sph = kind == KIND_SPHERE
        dir_s, phi = _sphere_direction(u)
        p_area = v0 + e1[:, 0:1] * dir_s

        # Visible-cap cone. The frame axis points from the center to the
        # shading point; α is the polar angle of the sampled normal.
        rad = e1[:, 0]
        ro = origin - v0
        dc2 = torch.sum(ro * ro, dim=-1)
        dc = torch.sqrt(torch.clamp(dc2, min=1e-20))
        outside = dc2 > rad * rad * 1.0002
        sin2max = torch.clamp(rad * rad / torch.clamp(dc2, min=1e-20),
                              0.0, 1.0)
        cosmax = torch.sqrt(torch.clamp(1.0 - sin2max, min=0.0))
        one_minus = sin2max / (1.0 + cosmax)
        cost = 1.0 - u[:, 1] * one_minus
        sin2t = torch.clamp(1.0 - cost * cost, min=0.0)
        ds = dc * cost - torch.sqrt(
            torch.clamp(rad * rad - dc2 * sin2t, min=0.0))
        cosa = torch.clamp(
            (dc2 + rad * rad - ds * ds)
            / torch.clamp(2.0 * dc * rad, min=1e-20),
            -1.0, 1.0,
        )
        sina = torch.sqrt(torch.clamp(1.0 - cosa * cosa, min=0.0))
        w_axis = ro / dc[:, None]
        t1, t2 = linalg.orthonormal_basis(w_axis)
        n_cone = ((sina * torch.cos(phi))[:, None] * t1
                  + (sina * torch.sin(phi))[:, None] * t2
                  + cosa[:, None] * w_axis)
        p_cone = v0 + rad[:, None] * n_cone

        cone = is_sph & outside
        point = torch.where(cone[:, None], p_cone,
                            torch.where(is_sph[:, None], p_area, point))
        normal = torch.where(
            is_sph[:, None], torch.where(cone[:, None], n_cone, dir_s),
            normal)
        pdf_cone = (2.0 * lum * rad * rad
                    / (lights.total_power * one_minus + 1e-20))

    wi_vec = point - origin
    dist2 = linalg.dot(wi_vec, wi_vec)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-12))
    cos_l = torch.abs(linalg.dot(normal, wi_vec / dist[:, None]))
    pdf_sa = dist2 * lum / (cos_l * lights.total_power + 1e-20)
    if cone is not None:
        pdf_sa = torch.where(cone, pdf_cone, pdf_sa)
    if with_uv:
        uv0, uv_e1, uv_e2, tex = sel[6:]
        return point, normal, emit, pdf_sa, uv0 + a * uv_e1 + b * uv_e2, tex
    return point, normal, emit, pdf_sa


# ---------------------------------------------------------------------------
# Delta lights (point / spot / directional)

DELTA_POSITIONAL = 0   # point / spot: intensity is radiant W/sr
DELTA_DIRECTIONAL = 1  # direction is the travel direction; intensity is
#                        the irradiance on a surface facing the light


class DeltaLights(NamedTuple):
    position: torch.Tensor   # (L, 3) f32 (directional rows: zeros)
    intensity: torch.Tensor  # (L, 3) f32 (see the kinds above)
    direction: torch.Tensor  # (L, 3) f32 unit spot axis / travel direction
    cos_inner: torch.Tensor  # (L,) f32 spot: full intensity inside
    cos_outer: torch.Tensor  # (L,) f32 spot: zero outside (-2 = no cone)
    kind: torch.Tensor       # (L,) i32 DELTA_POSITIONAL | DELTA_DIRECTIONAL
    cum: torch.Tensor        # (L,) f32 inclusive pick CDF (power-weighted)
    prob: torch.Tensor       # (L,) f32 pick probability of each row


def build_delta_lights(specs, device):
    """The table of a list of light dicts, built in numpy as the JAX
    package builds it and uploaded to ``device``; None for no lights (or
    no power):

      {"type": "point", "position": [..], "intensity": [r,g,b]}
      {"type": "spot", "position": [..], "direction": [..],
       "intensity": [..], "inner_degrees": 20, "outer_degrees": 30}
      {"type": "directional", "direction": [..], "irradiance": [r,g,b]}

    Pick weights follow the approximate emitted power: 4π·lum for points
    and directionals, the cone's solid angle (falloff band at half weight)
    times lum for spots."""
    if not specs:
        return None
    pos, inten, direc, ci, co, kind, power = [], [], [], [], [], [], []
    for s in specs:
        t = s["type"]
        if t == "directional":
            d = np.asarray(s["direction"], np.float64)
            d = d / np.linalg.norm(d)
            e = np.asarray(s.get("irradiance", s.get("intensity")),
                           np.float32)
            pos.append(np.zeros(3, np.float32))
            inten.append(e)
            direc.append(d.astype(np.float32))
            ci.append(-2.0)
            co.append(-2.0)
            kind.append(DELTA_DIRECTIONAL)
            lum = float(0.2126 * e[0] + 0.7152 * e[1] + 0.0722 * e[2])
            power.append(4.0 * np.pi * lum)
            continue
        p = np.asarray(s["position"], np.float32)
        e = np.asarray(s["intensity"], np.float32)
        lum = float(0.2126 * e[0] + 0.7152 * e[1] + 0.0722 * e[2])
        if t == "spot":
            d = np.asarray(s["direction"], np.float64)
            d = d / np.linalg.norm(d)
            inner = float(np.cos(np.radians(s.get("inner_degrees", 20.0))))
            outer = float(np.cos(np.radians(s.get("outer_degrees", 30.0))))
            if inner < outer:
                raise ValueError("spot inner cone must be <= outer cone")
            power.append(2.0 * np.pi * (1.0 - 0.5 * (inner + outer)) * lum)
        elif t == "point":
            d = np.array([0.0, -1.0, 0.0], np.float64)
            inner, outer = -2.0, -2.0
            power.append(4.0 * np.pi * lum)
        else:
            raise ValueError(f"unknown delta light type: {t!r}")
        pos.append(p)
        inten.append(e)
        direc.append(d.astype(np.float32))
        ci.append(inner)
        co.append(outer)
        kind.append(DELTA_POSITIONAL)
    power = np.asarray(power, np.float64)
    total = power.sum()
    if total <= 0.0:
        return None

    def dev(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return DeltaLights(
        position=dev(np.stack(pos)), intensity=dev(np.stack(inten)),
        direction=dev(np.stack(direc)),
        cos_inner=dev(np.asarray(ci, np.float32)),
        cos_outer=dev(np.asarray(co, np.float32)),
        kind=dev(np.asarray(kind, np.int32), torch.int32),
        cum=dev(np.cumsum(power / total).astype(np.float32)),
        prob=dev((power / total).astype(np.float32)),
    )


def sample_delta(dl: DeltaLights, u, origin):
    """Pick one delta light per ray (power-weighted, the count Σ(u > cum)
    as in ``pick``) and evaluate it at ``origin`` (R, 3). Returns (wi (R, 3)
    unit direction toward the light, t_shadow (R,) occlusion query
    distance, radiance (R, 3): the unshadowed NEE radiance with falloff,
    1/d² and the pick probability folded in). Spots fall off by the
    smoothstep between their cone cosines; directional rows shadow toward
    t = 1e7."""
    n = dl.cum.shape[0]
    idx = torch.clamp(torch.sum((u[:, None] > dl.cum[None, :]).to(
        torch.int64), dim=1), 0, n - 1)
    p = dl.position[idx]
    e = dl.intensity[idx]
    axis = dl.direction[idx]
    cin = dl.cos_inner[idx]
    cout = dl.cos_outer[idx]
    prob = dl.prob[idx]

    is_dir = dl.kind[idx] == DELTA_DIRECTIONAL
    to_l = p - origin
    dist2 = linalg.dot(to_l, to_l)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-12))
    wi_pos = to_l / dist[:, None]
    wi = torch.where(is_dir[:, None], -axis, wi_pos)
    t_shadow = torch.where(is_dir, 1.0e7, dist * (1.0 - 1e-3))

    cosang = linalg.dot(axis, -wi_pos)
    tt = torch.clamp((cosang - cout) / torch.clamp(cin - cout, min=1e-6),
                     0.0, 1.0)
    falloff = torch.where(cout > -1.5, tt * tt * (3.0 - 2.0 * tt), 1.0)

    rad_pos = e * (falloff / torch.clamp(dist2, min=1e-12))[:, None]
    radiance = torch.where(is_dir[:, None], e, rad_pos)
    return wi, t_shadow, radiance / torch.clamp(prob, min=1e-12)[:, None]
