"""Small-vector math on trailing-dim-3 float32 tensors (the JAX package's
``ops/linalg.py``). Dot products are written out term by term so their
summation order is fixed on every device."""

from __future__ import annotations

import torch

EPS = 1e-8


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def length(v):
    return torch.sqrt(torch.clamp(dot(v, v), min=0.0))


def normalize(v):
    return v * (1.0 / torch.clamp(length(v), min=EPS))[..., None]


def cross(a, b):
    return torch.stack(
        [a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
         a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
         a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1,
    )


def reflect(d, n):
    """Mirror ``d`` about normal ``n`` (both unit)."""
    return d - 2.0 * dot(d, n)[..., None] * n


def refract(d, n, eta):
    """Refract unit ``d`` through unit normal ``n`` with relative IOR
    ``eta``; callers gate on total internal reflection themselves."""
    cos_i = torch.clamp(-dot(d, n), max=1.0)
    perp = eta[..., None] * (d + cos_i[..., None] * n)
    par_sq = torch.clamp(1.0 - dot(perp, perp), min=0.0)
    return perp - torch.sqrt(par_sq)[..., None] * n


def orthonormal_basis(n):
    """Branchless ONB from a unit normal (Duff et al. 2017).
    Returns (t, b) such that (t, b, n) is right-handed orthonormal."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    bv = n[..., 0] * n[..., 1] * a
    t = torch.stack(
        [1.0 + s * n[..., 0] * n[..., 0] * a, s * bv, -s * n[..., 0]], dim=-1
    )
    b = torch.stack([bv, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, b


def luminance(rgb):
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
