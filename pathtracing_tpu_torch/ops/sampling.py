"""Monte Carlo sampling primitives (the JAX package's ``ops/sampling.py``).
All take explicit uniforms."""

from __future__ import annotations

import torch

from pathtracing_tpu_torch.ops import linalg

PI = 3.141592653589793
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


def hg_phase(g, cos_t):
    """Henyey–Greenstein phase value p(cosθ), normalized over the sphere,
    so it is also the solid-angle pdf of ``hg_sample``."""
    g2 = g * g
    denom = torch.clamp(1.0 + g2 - 2.0 * g * cos_t, min=1e-6)
    return (1.0 - g2) / (4.0 * PI * denom * torch.sqrt(denom))


def hg_sample(d, g, u1, u2):
    """A Henyey–Greenstein direction about the incident direction ``d``:
    (direction, cosθ). ``|g| < 1e-3`` takes the isotropic inversion (the
    HG inversion divides by g). The direction's pdf is
    ``hg_phase(g, cosθ)``. ``g``: a 0-d or per-ray tensor."""
    small = torch.abs(g) < 1e-3
    safe_g = torch.where(small, 1e-3, g)
    sq = (1.0 - safe_g * safe_g) / torch.clamp(
        1.0 - safe_g + 2.0 * safe_g * u1, min=1e-6)
    cos_hg = (1.0 + safe_g * safe_g - sq * sq) / (2.0 * safe_g)
    cos_t = torch.clamp(torch.where(small, 1.0 - 2.0 * u1, cos_hg), -1.0,
                        1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = TWO_PI * u2
    t, b = linalg.orthonormal_basis(d)
    out = ((sin_t * torch.cos(phi))[..., None] * t
           + (sin_t * torch.sin(phi))[..., None] * b
           + cos_t[..., None] * d)
    return linalg.normalize(out), cos_t
