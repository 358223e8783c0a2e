"""AOV (arbitrary output variable) passes (the JAX package's
``models/aov.py``): normal, depth, albedo, material id and uv images.

Each pass is one closest-hit query of the first sample's primary rays and
elementwise shading; misses show the configured background. Smooth
shading normals and textures feed the buffers as they feed the
integrator.
"""

from __future__ import annotations

import torch

from pathtracing_tpu_torch.models import scene as scene_mod
from pathtracing_tpu_torch.models import shading
from pathtracing_tpu_torch.ops import materials
from pathtracing_tpu_torch.ops import texture as texture_ops
from pathtracing_tpu_torch.utils.config import RenderConfig

AOV_KINDS = ("normal", "depth", "albedo", "mat_id", "uv")


def _select(i, values):
    """``values[i]`` per element for an index tensor ``i`` in [0, 6)."""
    out = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    for j in reversed(range(len(values))):
        out = torch.where(i == j, values[j], out)
    return out


def render_aov(scene, camera, config: RenderConfig, kind: str):
    """One AOV image (H, W, 3) f32 in [0, 1] (depth normalized by its
    in-frame maximum; mat_id as a categorical colour ramp)."""
    if kind not in AOV_KINDS:
        raise ValueError(f"unknown AOV {kind!r}; have {AOV_KINDS}")
    h, w = config.height, config.width
    pix = torch.arange(h * w, dtype=torch.int64, device=scene.tri_v0.device)
    _, origin, direction = shading.camera_sample(camera, config,
                                                 int(config.seed), pix, 0)
    hit = scene_mod.intersect_batch(scene, origin, direction,
                                    config.resolve_traversal(scene))
    bg = shading.background_radiance(direction, config.background)
    valid = hit.valid[:, None]

    uv = None
    if scene.attr_shn is not None or scene.textures is not None:
        s_normal, uv = scene_mod.surface_attributes(scene, hit)
        if scene.attr_shn is not None:
            hit = hit._replace(normal=s_normal)

    if kind == "normal":
        # The reference's shade: colour = n * 0.5 + 0.5.
        img = torch.where(valid, hit.normal * 0.5 + 0.5, bg)
    elif kind == "uv":
        if uv is None:
            uv = torch.zeros((h * w, 2), dtype=torch.float32,
                             device=pix.device)
        img = torch.where(valid, torch.stack(
            [torch.remainder(uv[:, 0], 1.0), torch.remainder(uv[:, 1], 1.0),
             torch.zeros_like(uv[:, 0])], dim=-1), bg)
    elif kind == "depth":
        t = torch.where(hit.valid, hit.t, 0.0)
        t_max = torch.clamp(t.max(), min=1e-6)
        img = torch.where(valid, (1.0 - t / t_max)[:, None].expand(-1, 3),
                          bg)
    elif kind == "albedo":
        mtype, alb, par, emit = materials.gather(scene.material_table,
                                                 hit.mat_id)
        alb = materials.effective_albedo(mtype, alb, par, emit, hit.position)
        emit = materials.effective_emission(mtype, emit)
        if scene.textures is not None and uv is not None:
            tex_id = scene.mat_tex[torch.clamp(
                hit.mat_id, 0, scene.mat_tex.shape[0] - 1).long()]
            tex_rgb = texture_ops.sample_bilinear(scene.textures, tex_id, uv)
            alb = torch.where(((tex_id >= 0) & hit.valid)[:, None],
                              alb * tex_rgb, alb)
        # Emitters show as (clipped) white.
        img = torch.where(valid, torch.clamp(alb + emit, 0.0, 1.0), bg)
    else:  # mat_id: golden-ratio hue steps, HSV(h, 0.65, 0.95) -> RGB
        k = hit.mat_id.to(torch.float32)
        hue = torch.remainder(k * 0.61803398875, 1.0)
        i = torch.floor(hue * 6.0)
        f = hue * 6.0 - i
        v, s = 0.95, 0.65
        p, q, tt = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
        i = torch.remainder(i.to(torch.int32), 6)
        rgb = torch.stack([_select(i, (v, q, p, p, tt, v)),
                           _select(i, (tt, v, v, q, p, p)),
                           _select(i, (p, p, tt, v, v, q))], dim=-1)
        img = torch.where(valid, rgb, bg)
    return img.reshape(h, w, 3)
