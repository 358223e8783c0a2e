"""Analytic intersection (the JAX package's ``ops/intersect.py``):
ray–sphere, Möller–Trumbore ray–triangle and the ray–AABB slab test, all
elementwise over leading dims (multiply-adds, never a matmul)."""

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


def ray_triangle(origin, direction, v0, e1, e2, t_min=T_MIN, t_max=INF):
    """Möller–Trumbore ray–triangle distance, +inf on miss (two-sided,
    ``e1 = v1 - v0``, ``e2 = v2 - v0``)."""
    pvec = linalg.cross(direction, e2)
    det = linalg.dot(e1, pvec)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    tvec = origin - v0
    u = linalg.dot(tvec, pvec) * inv_det
    qvec = linalg.cross(tvec, e1)
    v = linalg.dot(direction, qvec) * inv_det
    t = linalg.dot(e2, qvec) * inv_det
    valid = ((torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > t_min) & (t < t_max))
    return torch.where(valid, t, INF)


def ray_aabb(origin, inv_direction, box_min, box_max, t_max):
    """Slab test with a precomputed ``1/direction``: (hit before
    ``t_max``, t_near)."""
    t0 = (box_min - origin) * inv_direction
    t1 = (box_max - origin) * inv_direction
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (t_near <= t_far) & (t_far > T_MIN) & (t_near < t_max)
    return hit, t_near
