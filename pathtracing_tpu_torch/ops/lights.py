"""Area-light table + sampling for next-event estimation (the JAX
package's ``ops/lights.py``, triangle lights with small tables).

The table holds every emissive triangle, picked with probability ∝
emitted power (luminance · area) by a power CDF; the point within the
picked triangle is area-uniform, so the per-area pdf at a sample of light
i is lum_i / total_power. The pick index equals the JAX package's: same
CDF (built in float64 on the host, stored float32) and the same
Σ(u > cum) count.

Not ported yet: emissive spheres (visible-cap cone sampling), textured
emitters, the many-light gather mode (tables of ``_GATHER_MIN`` or more
lights, which needs ROADMAP queue B row 3) and delta lights — all
ROADMAP queue A item 11.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pathtracing_tpu_torch.ops import linalg

_GATHER_MIN = 192  # the JAX package's switch to the gather-mode pick


class LightTable(NamedTuple):
    v0: torch.Tensor          # (L, 3) f32 triangle corner
    e1: torch.Tensor          # (L, 3) f32 edge 1
    e2: torch.Tensor          # (L, 3) f32 edge 2
    normal: torch.Tensor      # (L, 3) f32 unit geometric normal
    emit: torch.Tensor        # (L, 3) f32 radiance
    cum: torch.Tensor         # (L,)  f32 inclusive cumulative power fraction
    total_area: torch.Tensor  # () f32 — 0 means "no lights" (NEE no-op)
    total_power: torch.Tensor  # () f32 Σ luminance·area


def build_light_table(v0, v1, v2, tri_mat, mat_type, mat_emit,
                      emissive_type: int, device, sph_center=None,
                      sph_radius=None, sph_mat=None) -> LightTable:
    """Host-side (numpy) collection of the emissive triangles, uploaded to
    ``device``."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    tri_mat = np.asarray(tri_mat)
    types = np.asarray(mat_type)
    emits = np.asarray(mat_emit, np.float32)[tri_mat]
    if sph_center is not None and len(sph_center):
        sm = np.asarray(sph_mat)
        sr = np.asarray(sph_radius, np.float32)
        if ((types[sm] == emissive_type) & (sr > 1e-12)).any():
            raise NotImplementedError(
                "emissive spheres are not ported yet (ROADMAP queue A "
                "item 11)"
            )
    sel = types[tri_mat] == emissive_type
    lv0, lv1, lv2 = v0[sel], v1[sel], v2[sel]
    lemit = emits[sel]

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
    normal = (n / np.maximum(norm[:, None], 1e-20)).astype(np.float32)

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
            emit=dev(zero3), cum=dev(np.ones(1, np.float32)),
            total_area=dev(np.float32(0.0)),
            total_power=dev(np.float32(0.0)),
        )
    if lv0.shape[0] >= _GATHER_MIN:
        raise NotImplementedError(
            f"{lv0.shape[0]} lights need the many-light gather mode, not "
            "ported yet (ROADMAP queue A item 11, queue B row 3)"
        )
    cum = np.cumsum(power) / total_power
    return LightTable(
        v0=dev(lv0), e1=dev(e1), e2=dev(e2), normal=dev(normal),
        emit=dev(lemit), cum=dev(cum.astype(np.float32)),
        total_area=dev(np.float32(float(area.sum()))),
        total_power=dev(np.float32(total_power)),
    )


def pick(lights: LightTable, u0):
    """Power-CDF light pick: index = Σ(u0 > cum), clipped to [0, L-1]
    (the JAX small-table branch of ``_pick_and_select``)."""
    n_lights = lights.cum.shape[0]
    idx = torch.sum((u0[:, None] > lights.cum[None, :]).to(torch.int64),
                    dim=1)
    return torch.clamp(idx, 0, n_lights - 1)


def sample_solid_angle(lights: LightTable, u, origin):
    """NEE light sample with its per-solid-angle pdf.

    u: (R, 3) uniforms; origin: (R, 3) shading points. Returns
    (point (R,3), normal (R,3), emit (R,3), pdf_sa (R,)), with
    pdf_sa = dist² · lum / (cosθ_l · total_power)."""
    idx = pick(lights, u[:, 0])
    v0, e1, e2 = lights.v0[idx], lights.e1[idx], lights.e2[idx]
    normal, emit = lights.normal[idx], lights.emit[idx]

    su = torch.sqrt(torch.clamp(u[:, 1:2], min=1e-12))
    a = 1.0 - su
    b = su * u[:, 2:3]
    point = v0 + a * e1 + b * e2

    lum = linalg.luminance(emit)
    wi_vec = point - origin
    dist2 = linalg.dot(wi_vec, wi_vec)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-12))
    cos_l = torch.abs(linalg.dot(normal, wi_vec / dist[:, None]))
    pdf_sa = dist2 * lum / (cos_l * lights.total_power + 1e-20)
    return point, normal, emit, pdf_sa
