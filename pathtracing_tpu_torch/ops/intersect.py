"""Analytic ray–sphere intersection (the JAX package's ``ops/intersect.py``,
as far as the cluster traversal path needs it)."""

from __future__ import annotations

import math

import torch

from pathtracing_tpu_torch.ops import linalg

INF = math.inf
T_MIN = 1e-3  # self-intersection bias


def ray_sphere(origin, direction, center, radius, t_min=T_MIN, t_max=INF):
    """Nearest hit distance of ray vs sphere, +inf on miss (broadcasts over
    leading dims). Picks the far root when the near root is behind
    ``t_min`` so rays starting inside a sphere (dielectrics) work."""
    oc = origin - center
    a = linalg.dot(direction, direction)
    half_b = linalg.dot(oc, direction)
    c = linalg.dot(oc, oc) - radius * radius
    disc = half_b * half_b - a * c
    sqrt_d = torch.sqrt(torch.clamp(disc, min=0.0))
    inv_a = 1.0 / a
    t_near = (-half_b - sqrt_d) * inv_a
    t_far = (-half_b + sqrt_d) * inv_a
    t = torch.where(t_near > t_min, t_near, t_far)
    valid = (disc > 0.0) & (t > t_min) & (t < t_max)
    return torch.where(valid, t, INF)
