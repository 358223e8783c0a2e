"""The reference kernel's image (the JAX package's ``models/reference.py``):
``Test.hlsl:1-40`` as one batched torch expression. Per pixel, uv =
(xy / res)·2 − 1 (y down), a pinhole at (0, 0, 1) looking down −z, the
ray–sphere quadratic against center (0, 0, 0), radius 0.5; a hit shades
normal·0.5 + 0.5, a miss (uv, 0).

As in the JAX package, the actual resolution sets the uv mapping (the
reference hard-codes 1080×1080 while dispatching 1920×1080; pass
``resolution`` to reproduce that), and the near root is taken even when
negative, as the reference does.
"""

from __future__ import annotations

import torch

from pathtracing_tpu_torch.utils.config import resolve_device


def render_reference(height: int, width: int, resolution=None,
                     device=None) -> torch.Tensor:
    """The reference test image, (height, width, 4) float32 RGBA on
    ``device`` (the card unless the caller asks for another device).
    ``resolution`` optionally overrides the (res_x, res_y) of the uv
    mapping."""
    device = resolve_device(device)
    res_x, res_y = resolution if resolution is not None else (width, height)
    ys, xs = torch.meshgrid(
        torch.arange(height, device=device), torch.arange(width,
                                                          device=device),
        indexing="ij")
    uv_x = (xs.to(torch.float32) / res_x) * 2.0 - 1.0
    uv_y = (ys.to(torch.float32) / res_y) * 2.0 - 1.0

    cam = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=device)
    d = torch.stack([uv_x, uv_y, -torch.ones_like(uv_x)], dim=-1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    radius = 0.5

    # The quadratic (Test.hlsl:16-21), oc = cam - center = cam.
    oc = cam
    a = torch.sum(d * d, dim=-1)
    b = 2.0 * torch.sum(oc * d, dim=-1)
    c = torch.sum(oc * oc) - radius * radius
    disc = b * b - 4.0 * a * c

    # The hit branch (Test.hlsl:24-32): the near root, even if negative.
    t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a)
    p = cam + t[..., None] * d
    n = p / torch.linalg.vector_norm(p, dim=-1, keepdim=True)
    hit_rgb = n * 0.5 + 0.5
    miss_rgb = torch.stack([uv_x, uv_y, torch.zeros_like(uv_x)], dim=-1)

    rgb = torch.where((disc > 0.0)[..., None], hit_rgb, miss_rgb)
    alpha = torch.ones(rgb.shape[:-1] + (1,), dtype=torch.float32,
                       device=device)
    return torch.cat([rgb, alpha], dim=-1)
