"""The instanced field of ``instanced_field`` (the same generator, data
and port build), checked by a reference that computes with the port's
float32 arithmetic where the field's scale makes two float32 tracers part:
its camera frame and its triangle tests.

* The frame. ``reference/pathtrace.py``'s ``camera_frame`` multiplies the
  float32 axes by ``np.tan(...)``, a numpy float64 scalar, so under numpy
  2 its frame is computed in float64 and rounded once, where the port and
  the JAX package round each step in float32 (``math.tan``, a Python
  float). The Cornell cells' frames come out the same bits either way; the
  field's differ in the last bit of ``lower_left`` and ``vertical``, which
  moves its first hits, at t near 80, by about 1.6e-4. ``frame`` below is
  ``camera_frame`` with the scalar a Python float; this module's reference
  traces from it.
* The intersection: ``reference/woop.py`` (the instanced reference's
  culling, groups and placements, with the Woop test and the port's
  object-space move; its note says why).

The paths, the shading, the light picks and the sums stay the plain
reference's (``pathtrace.render``, ``check.Reference``)."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ptbench import check
from ptbench.reference import pathtrace, woop
from ptbench.scenes.instanced_field import (  # noqa: F401
    base_triangles, build_port, proto_triangles, scene_data)


def frame(camera: dict, aspect: float):
    """Pinhole frame (origin, lower_left, horizontal, vertical) as float32
    numpy, each step rounded in float32 as the port's ``build_camera``
    rounds it."""
    position = np.asarray(camera["position"], np.float32)
    look_at = np.asarray(camera["look_at"], np.float32)
    up = np.asarray(camera["up"], np.float32)
    half_h = float(np.tan(np.radians(camera["vfov_degrees"]) / 2.0))
    half_w = aspect * half_h
    w = position - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    lower_left = position - half_w * u - half_h * v - w
    return position, lower_left, 2.0 * half_w * u, 2.0 * half_h * v


@contextlib.contextmanager
def _frame_in_float32():
    """``pathtrace.render`` takes its frame from ``frame`` while open."""
    kept = pathtrace.camera_frame
    pathtrace.camera_frame = frame
    try:
        yield
    finally:
        pathtrace.camera_frame = kept


class Reference(check.Reference):
    """``check.Reference`` whose paths start from ``frame``'s rays."""

    def sums(self, *args, **kwargs):
        with _frame_in_float32():
            return super().sums(*args, **kwargs)


def reference(data: dict, config: dict, device, dtype=torch.float32):
    """The field's geometry (``woop.prepare``: base triangles, the
    prototype, the placements) and lights, tracing from ``frame``."""
    base = base_triangles(data)
    geo = woop.prepare(base, [proto_triangles(data)],
                       [(0, m, o) for m, o in data["placements"]],
                       device, dtype)
    return Reference(data, base, config, device, dtype, geo=geo)
