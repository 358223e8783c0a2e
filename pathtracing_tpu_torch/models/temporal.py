"""Temporal reuse across frames (the JAX package's ``models/temporal.py``):
each new low-spp frame of a camera sequence blends into the previous
frames' history, reprojected through the camera motion.

A step is a feature pass (one closest-hit query of pixel-centre primary
rays: position, depth, normal, material), ``ops.camera.project`` of the
hit points into the previous camera, a bilinear gather of the history in
which each of the 4 taps counts only if it was valid, depth- and
normal-consistent and on the same material, and a running-mean blend with
a per-pixel history length. Specular primaries and a one-pixel band
around emitters keep a short history, since their radiance moves with the
camera. Pixels with no surviving tap restart at the current frame.

Temporal blending is biased during motion (history samples come from
slightly different shading points); the history cap bounds that.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from pathtracing_tpu_torch.models import scene as scene_mod
from pathtracing_tpu_torch.ops import camera as camera_ops
from pathtracing_tpu_torch.ops import materials
from pathtracing_tpu_torch.utils.config import RenderConfig, resolve_device

# Default history cap: at most this many frames blend into a pixel.
HISTORY_CAP = 16.0


class TemporalState(NamedTuple):
    """History buffers carried across frames."""

    history: torch.Tensor   # (H, W, 3) — mean radiance of blended frames
    hist_len: torch.Tensor  # (H, W) — effective frames accumulated
    depth: torch.Tensor     # (H, W) — cam_depth of the primary hit
    normal: torch.Tensor    # (H, W, 3) — primary shading normal
    valid: torch.Tensor     # (H, W) bool — primary hit exists
    mat: torch.Tensor       # (H, W) i32 — primary material id (-1 = miss)


def init_state(config: RenderConfig, device=None) -> TemporalState:
    """Empty history on ``device`` (the card unless the caller asks for
    another device)."""
    device = resolve_device(device)
    h, w = config.height, config.width

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return TemporalState(
        history=zeros(h, w, 3), hist_len=zeros(h, w), depth=zeros(h, w),
        normal=zeros(h, w, 3),
        valid=torch.zeros((h, w), dtype=torch.bool, device=device),
        mat=torch.full((h, w), -1, dtype=torch.int32, device=device),
    )


def _center_rays(camera, config: RenderConfig, device):
    """Pixel-centre primary rays through the lens centre (no jitter): the
    film mapping of ``shading.camera_sample`` (row 0 at the top) and the
    sharp pinhole mapping that ``project`` inverts. A motion pair uses its
    mid-shutter pose."""
    h, w = config.height, config.width
    pix = torch.arange(h * w, dtype=torch.int64, device=device)
    x = (pix % w).to(torch.float32)
    y = (h - 1 - pix // w).to(torch.float32)
    s = (x + 0.5) / w
    t = (y + 0.5) / h
    zeros = torch.zeros_like(s)
    cam = dataclasses.replace(camera_ops.resolve(camera), lens_radius=0.0)
    return camera_ops.generate_ray(cam, s, t, zeros, zeros)


def features(scene, camera, config: RenderConfig):
    """Primary-visibility buffers for reprojection: (position (H, W, 3),
    depth (H, W), normal (H, W, 3), valid, specular mask, emitter band,
    material id (H, W), -1 on a miss)."""
    h, w = config.height, config.width
    o, d = _center_rays(camera, config, scene.tri_v0.device)
    hit = scene_mod.intersect_batch(scene, o, d,
                                    config.resolve_traversal(scene))
    normal = hit.normal
    if scene.attr_shn is not None:
        normal, _ = scene_mod.surface_attributes(scene, hit)
    # A miss's hit record may hold inf/NaN: zero it so that a bilinear
    # history gather next to a miss stays finite, and park the miss at the
    # camera origin with depth 0 (the validity mask rejects it).
    normal = torch.where(hit.valid[:, None], normal, 0.0)
    pos = torch.where(hit.valid[:, None], o + hit.t[:, None] * d, o)
    cam = camera_ops.resolve(camera)
    depth = torch.where(hit.valid, camera_ops.cam_depth(cam, pos), 0.0)
    # Mirror-like primaries carry view-dependent radiance: their history
    # is stale as soon as the camera moves, so ``advance`` caps it short.
    mtype, _, par, _ = materials.gather(scene.material_table, hit.mat_id)
    spec = (
        (mtype == materials.TYPE_DIELECTRIC)
        | (mtype == materials.TYPE_ROUGH_DIELECTRIC)
        | ((mtype == materials.TYPE_METAL) & (par < 0.25))
        | ((mtype == materials.TYPE_GGX) & (par < 0.2))
        | ((mtype == materials.TYPE_PRINCIPLED) & (par < 0.2))
    ) & hit.valid
    # Emitter-edge band: emissive primaries dilated by one pixel. A pixel
    # at a light's silhouette holds sub-pixel coverage of the light, which
    # sweeps with the camera; it gets the short cap too.
    emis = ((mtype == materials.TYPE_EMISSIVE) & hit.valid).reshape(h, w)
    emis_band = emis
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                emis_band = emis_band | torch.roll(emis, (dy, dx), (0, 1))
    mat = torch.where(hit.valid, hit.mat_id, -1).to(torch.int32)
    return (pos.reshape(h, w, 3), depth.reshape(h, w),
            normal.reshape(h, w, 3), hit.valid.reshape(h, w),
            spec.reshape(h, w), emis_band, mat.reshape(h, w))


def advance(state: TemporalState, cur_img, scene, camera, cam_prev,
            config: RenderConfig, depth_tol: float = 0.05,
            normal_tol: float = 0.7, cap: float = HISTORY_CAP,
            spec_cap: float = 3.0) -> Tuple[torch.Tensor, TemporalState]:
    """Blend one new frame into the reprojected history.

    ``cur_img`` ((H, W, 3), this frame's mean radiance) was rendered with
    ``camera``; ``cam_prev`` is the previous frame's pose (the current one
    for frame 0: an empty history blends to the current frame). Each of
    the 4 bilinear taps under the reprojected point counts with its
    bilinear weight only if that history texel was valid, within
    ``depth_tol`` (relative) of the point's depth in the previous camera,
    within ``normal_tol`` (cosine) of its normal and on the same material;
    the weights renormalize. Specular primaries keep at most ``spec_cap``
    frames, the emitter band fewer as the reprojected pixel motion grows.
    Returns (display image, new state)."""
    h, w = config.height, config.width
    pos, depth_c, normal_c, valid_c, spec_c, emis_band, mat_c = features(
        scene, camera, config)

    prev = camera_ops.resolve(cam_prev)
    s, t, in_front = camera_ops.project(prev, pos.reshape(-1, 3))
    s = s.reshape(h, w)
    t = t.reshape(h, w)
    in_front = in_front.reshape(h, w)
    # Film -> pixel coordinates (the _center_rays mapping inverted).
    xf = s * w - 0.5
    yf = (h - 0.5) - t * h
    # The full film extent: pixel centres sit at integers, the film edge
    # half a pixel beyond.
    in_bounds = (xf > -0.5) & (xf < w - 0.5) & (yf > -0.5) & (yf < h - 0.5)
    d_expect = camera_ops.cam_depth(prev, pos.reshape(-1, 3)).reshape(h, w)

    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    fx = xf - x0
    fy = yf - y0

    hist_acc = torch.zeros_like(cur_img)
    len_acc = torch.zeros_like(xf)
    w_acc = torch.zeros_like(xf)
    for dy, dx, bw in ((0.0, 0.0, (1 - fx) * (1 - fy)),
                       (0.0, 1.0, fx * (1 - fy)),
                       (1.0, 0.0, (1 - fx) * fy),
                       (1.0, 1.0, fx * fy)):
        # Out-of-range coordinates clamp before the integer cast, as
        # XLA's saturating float-to-int conversion leaves them outside.
        yi = torch.clamp(y0 + dy, -1.0, float(h)).to(torch.int64)
        xi = torch.clamp(x0 + dx, -1.0, float(w)).to(torch.int64)
        tap_in = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = torch.clamp(yi, 0, h - 1)
        xc = torch.clamp(xi, 0, w - 1)
        nrm_t = state.normal[yc, xc]
        ok = (
            tap_in & state.valid[yc, xc]
            & (state.mat[yc, xc] == mat_c)
            & ((state.depth[yc, xc] - d_expect).abs()
               < depth_tol * torch.clamp(d_expect, min=1e-3))
            & ((nrm_t * normal_c).sum(-1) > normal_tol)
        )
        wt = torch.where(ok, bw, 0.0)
        hist_acc = hist_acc + state.history[yc, xc] * wt[..., None]
        len_acc = len_acc + state.hist_len[yc, xc] * wt
        w_acc = w_acc + wt

    accept = valid_c & in_front & in_bounds & (w_acc > 1e-3)
    norm = torch.clamp(w_acc, min=1e-3)[..., None]
    hist = hist_acc / norm
    n_prev = len_acc / norm[..., 0]

    short = min(cap, spec_cap)
    cap_px = torch.where(spec_c, short, cap)
    # The emitter band's history shortens with the reprojected pixel
    # motion: a static camera keeps the short cap, >= 1 px a frame drops
    # to about no reuse.
    px = torch.arange(w, dtype=torch.float32, device=xf.device)[None, :]
    py = torch.arange(h, dtype=torch.float32, device=xf.device)[:, None]
    motion = torch.sqrt((xf - px) ** 2 + (yf - py) ** 2)
    emis_cap = 1.0 + (short - 1.0) / (1.0 + motion)
    cap_px = torch.where(emis_band, torch.minimum(cap_px, emis_cap), cap_px)
    n_eff = torch.minimum(torch.where(accept, n_prev, 0.0), cap_px - 1.0)
    out = (hist * n_eff[..., None] + cur_img) / (n_eff[..., None] + 1.0)
    new_len = torch.minimum(n_eff + 1.0, cap_px)
    return out, TemporalState(history=out, hist_len=new_len, depth=depth_c,
                              normal=normal_c, valid=valid_c, mat=mat_c)
