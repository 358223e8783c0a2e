"""Edge-avoiding à-trous wavelet denoiser over the feature buffers (the
JAX package's ``ops/denoise.py``; Dammertz et al., HPG 2010).

Five iterations at dilations 1, 2, 4, 8, 16 of a 25-tap B3-spline
stencil, each tap weighted by the colour, normal and relative-depth
distances to the centre pixel; hit and miss pixels never mix. Before the
filter, a firefly clamp against 3x3 neighbourhood means (Gaussian range
weights would keep an outlier); the filter runs on irradiance (radiance
over albedo, so texture detail does not blur) and multiplies the albedo
back. ``sigma_color`` defaults to ``2.8 / sqrt(spp)`` and halves each
iteration. Borders replicate the edge pixels; the taps add in the JAX
loop order (dy outer, dx inner).
"""

from __future__ import annotations

import torch

from pathtracing_tpu_torch.models import scene as scene_mod
from pathtracing_tpu_torch.ops import camera as camera_ops
from pathtracing_tpu_torch.ops import materials

# 1D B3-spline binomial kernel; the 5x5 filter is its outer product.
_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def guidance_buffers(scene, camera, config):
    """First-hit feature buffers at pixel centres through the lens centre
    (so noise-free whatever the aperture; a motion pair at mid-shutter):
    ``(normal (H, W, 3), albedo (H, W, 3), depth (H, W), valid (H, W)
    f32)``."""
    h, w = config.height, config.width
    pix = torch.arange(h * w, dtype=torch.int64, device=scene.tri_v0.device)
    x = (pix % w).to(torch.float32)
    y = (h - 1 - pix // w).to(torch.float32)
    s = (x + 0.5) / w
    t = (y + 0.5) / h
    half = torch.full_like(s, 0.5)
    cam = camera_ops.resolve(camera)
    origin, direction = camera_ops.generate_ray(cam, s, t, half, half)
    hit = scene_mod.intersect_batch(scene, origin, direction,
                                    config.resolve_traversal(scene))
    mtype, alb, par, emit = materials.gather(scene.material_table,
                                             hit.mat_id)
    alb = materials.effective_albedo(mtype, alb, par, emit, hit.position)
    valid = hit.valid[:, None]
    return (
        torch.where(valid, hit.normal, 0.0).reshape(h, w, 3),
        torch.where(valid, alb, 1.0).reshape(h, w, 3),
        torch.where(hit.valid, hit.t, 0.0).reshape(h, w),
        hit.valid.to(torch.float32).reshape(h, w),
    )


def _pad_edge(a, r: int):
    """``a`` (H, W, ...) padded by ``r`` on both sides of H and W with its
    edge values (``jnp.pad(mode="edge")``)."""
    h, w = a.shape[0], a.shape[1]
    iy = torch.clamp(torch.arange(-r, h + r, device=a.device), 0, h - 1)
    ix = torch.clamp(torch.arange(-r, w + r, device=a.device), 0, w - 1)
    return a[iy][:, ix]


def _atrous_iteration(img, normal, depth, valid, dilation, sigma_color,
                      sigma_normal, sigma_depth):
    h, w, _ = img.shape
    r = 2 * dilation
    pimg, pn, pd, pv = (_pad_edge(a, r) for a in (img, normal, depth, valid))
    inv_sc2 = 1.0 / (sigma_color * sigma_color)
    inv_sn2 = 1.0 / (sigma_normal * sigma_normal)
    inv_sd2 = 1.0 / (sigma_depth * sigma_depth)

    acc = torch.zeros_like(img)
    wacc = torch.zeros((h, w), dtype=img.dtype, device=img.device)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            k = _B3[dy + 2] * _B3[dx + 2]
            oy, ox = r + dy * dilation, r + dx * dilation
            q_img = pimg[oy:oy + h, ox:ox + w]
            q_n = pn[oy:oy + h, ox:ox + w]
            q_d = pd[oy:oy + h, ox:ox + w]
            q_v = pv[oy:oy + h, ox:ox + w]
            dc2 = ((img - q_img) ** 2).sum(-1)
            dn2 = ((normal - q_n) ** 2).sum(-1)
            # Depth distance relative to the pair's scale: sigma_depth is
            # unitless, so one default spans scene scales.
            dscale = torch.clamp(torch.maximum(depth, q_d), min=1e-3)
            dd2 = ((depth - q_d) / dscale) ** 2
            wgt = (k * torch.exp(-dc2 * inv_sc2 - dn2 * inv_sn2
                                 - dd2 * inv_sd2)
                   # 1 when both pixels agree on validity, else 0.
                   * (1.0 - (valid - q_v).abs()))
            acc = acc + wgt[..., None] * q_img
            wacc = wacc + wgt
    # The centre tap always contributes k_centre · exp(0) > 0.
    return acc / wacc[..., None]


def _firefly_clamp(img, k: float):
    """Clamp each pixel to k × its 8-neighbour mean (+0.1 floor)."""
    h, w, _ = img.shape
    p = _pad_edge(img, 1)
    s = torch.zeros_like(img)
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            s = s + p[dy:dy + h, dx:dx + w]
    return torch.minimum(img, k * (s / 8.0) + 0.1)


def denoise(radiance, normal, albedo, depth, valid, *, spp=None,
            iterations=5, sigma_color=None, sigma_normal=0.35,
            sigma_depth=0.07, firefly_clamp=2.0, demodulate=True):
    """Denoise a resolved (H, W, 3) linear-radiance image with the buffers
    of ``guidance_buffers``. ``sigma_color`` defaults to
    ``2.8 / sqrt(spp)`` (float32, as the JAX package computes it) and
    halves each iteration; ``firefly_clamp=0`` disables the prefilter."""
    if sigma_color is None:
        n = torch.tensor(1.0 if spp is None else float(spp),
                         dtype=torch.float32, device=radiance.device)
        sigma_color = 2.8 / torch.sqrt(torch.clamp(n, min=1.0))
    radiance = radiance.to(torch.float32)
    if firefly_clamp:
        radiance = _firefly_clamp(radiance, firefly_clamp)
    if demodulate:
        # Pure emitters and misses carry about zero albedo: leave their
        # radiance unscaled rather than amplify it.
        lum = albedo.amax(dim=-1, keepdim=True)
        demod = torch.where(lum > 1e-3, torch.clamp(albedo, min=1e-3), 1.0)
    else:
        demod = torch.ones_like(radiance)
    img = radiance / demod
    for i in range(iterations):
        img = _atrous_iteration(img, normal, depth, valid, 2 ** i,
                                sigma_color / (2.0 ** i), sigma_normal,
                                sigma_depth)
    return img * demod


def denoise_render(scene, camera, config, radiance, *, spp=None,
                   iterations=5, sigma_color=None, sigma_normal=0.35,
                   sigma_depth=0.07, firefly_clamp=2.0):
    """The guidance buffers of ``scene`` and ``denoise``; ``spp`` defaults
    to ``config.samples_per_pixel`` (pass the resolved count for a
    progressive image)."""
    if spp is None:
        spp = config.samples_per_pixel
    normal, albedo, depth, valid = guidance_buffers(scene, camera, config)
    return denoise(radiance, normal, albedo, depth, valid, spp=spp,
                   iterations=iterations, sigma_color=sigma_color,
                   sigma_normal=sigma_normal, sigma_depth=sigma_depth,
                   firefly_clamp=firefly_clamp)
