"""Monte Carlo sampling primitives (the JAX package's ``ops/sampling.py``,
as far as the flagship path needs them). All take explicit uniforms."""

from __future__ import annotations

import torch

from pathtracing_tpu_torch.ops import linalg

TWO_PI = 6.283185307179586


def square_to_cosine_hemisphere(u1, u2):
    """Cosine-weighted direction in the local +z hemisphere (pdf = cosθ/π)."""
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def cosine_hemisphere(n, u1, u2):
    """Cosine-weighted direction about world-space unit normal ``n``."""
    local = square_to_cosine_hemisphere(u1, u2)
    t, b = linalg.orthonormal_basis(n)
    return local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n


def uniform_sphere(u1, u2):
    """Uniform direction on the unit sphere."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_in_sphere(u1, u2, u3):
    """Uniform point inside the unit ball (metal fuzz lobes)."""
    d = uniform_sphere(u1, u2)
    return d * torch.pow(torch.clamp(u3, min=1e-12), 1.0 / 3.0)[..., None]


def uniform_in_disk(u1, u2):
    """Uniform point in the unit disk (thin-lens aperture sampling)."""
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def schlick_fresnel(cos_i, ior_ratio):
    """Schlick's reflectance approximation for dielectrics."""
    r0 = (1.0 - ior_ratio) / (1.0 + ior_ratio)
    r0 = r0 * r0
    m = torch.clamp(1.0 - cos_i, 0.0, 1.0)
    return r0 + (1.0 - r0) * m * m * m * m * m
