"""Image-based environment light (the JAX package's ``ops/envmap.py``): a
lat-long radiance map with luminance·sinθ importance sampling and
solid-angle pdfs, so next-event estimation and MIS treat the environment
as a light. The tables are built on the host in numpy, exactly as the JAX
package builds them, and uploaded to one device.

The CDF inversions are ``torch.searchsorted`` (``side="left"``): the index
it returns is the count of CDF entries below ``u``, which is the JAX
package's ``sum(cdf < u)`` on every non-decreasing CDF, flat runs and
``u`` equal to an entry included. The row's conditional CDF is searched
in one flat float64 sequence, row ``r``'s entries shifted by ``2r`` (exact
in float64), so no (R, Ew) gather is formed.

Direction convention: +Y is up. ``v ∈ [0, 1]`` maps to the polar angle
``θ = vπ`` from +Y, ``u ∈ [0, 1)`` to the azimuth ``φ = (u − 0.5)·2π``,
with ``d = (sinθ·cosφ, cosθ, sinθ·sinφ)``.

Radiance ``.hdr`` files (Ward's RGBE, flat and adaptive-RLE scanlines)
are read and written in numpy on the host (``load_hdr``, ``write_hdr``);
``load_environment`` builds a map from a scene file's ``environment``
entry.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from pathtracing_tpu_torch.utils.config import resolve_device

_TWO_PI = 2.0 * np.pi
_INV_4PI = 1.0 / (4.0 * np.pi)


class EnvMap(NamedTuple):
    """Environment map tables on one device (all f32)."""

    texels: torch.Tensor    # (Eh, Ew, 3) radiance
    marg_cdf: torch.Tensor  # (Eh,) inclusive CDF over rows
    cond_cdf: torch.Tensor  # (Eh, Ew) inclusive CDF within each row
    marg_pdf: torch.Tensor  # (Eh,) per-row selection probability
    cond_pdf: torch.Tensor  # (Eh, Ew) per-texel in-row probability
    prob_map: torch.Tensor  # (Eh, Ew) per-texel selection probability
    uniform: torch.Tensor   # () 1.0 when the map is black: sampling then
    #                         falls back to the uniform sphere


def build_envmap(texels, device) -> EnvMap:
    """The tables of a (Eh, Ew, 3) radiance grid, built in numpy as the JAX
    package builds them (selection weight per texel = luminance × sinθ),
    uploaded to ``device``."""
    tx = np.asarray(texels, np.float32)
    if tx.ndim != 3 or tx.shape[2] != 3:
        raise ValueError(f"envmap texels must be (H, W, 3); got {tx.shape}")
    eh, ew, _ = tx.shape
    lum = tx @ np.array([0.2126, 0.7152, 0.0722], np.float32)
    theta = (np.arange(eh, dtype=np.float32) + 0.5) / eh * np.pi
    w = lum * np.sin(theta)[:, None]

    total = float(w.sum())
    uniform = total <= 0.0
    if uniform:
        w = np.ones_like(w) * np.sin(theta)[:, None]
        total = float(w.sum())

    row_w = w.sum(axis=1)
    marg_pdf = row_w / total
    marg_cdf = np.cumsum(marg_pdf)
    marg_cdf[-1] = 1.0

    safe_row = np.maximum(row_w, 1e-20)[:, None]
    cond_pdf = w / safe_row
    # Degenerate (all-zero) rows sample uniformly in azimuth.
    cond_pdf[row_w <= 0.0] = 1.0 / ew
    cond_cdf = np.cumsum(cond_pdf, axis=1)
    cond_cdf[:, -1] = 1.0
    prob = (marg_pdf[:, None] * cond_pdf).astype(np.float32)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return EnvMap(
        texels=dev(tx), marg_cdf=dev(marg_cdf), cond_cdf=dev(cond_cdf),
        marg_pdf=dev(marg_pdf), cond_pdf=dev(cond_pdf), prob_map=dev(prob),
        uniform=dev(1.0 if uniform else 0.0),
    )


def _texel_index(env: EnvMap, d):
    """Nearest texel (iy, ix) for unit directions d (..., 3)."""
    eh, ew = env.prob_map.shape
    v = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0)) / torch.pi
    u = torch.arctan2(d[..., 2], d[..., 0]) / _TWO_PI + 0.5
    iy = torch.clamp((v * eh).to(torch.int64), 0, eh - 1)
    ix = torch.clamp((u * ew).to(torch.int64), 0, ew - 1) % ew
    return iy, ix


def radiance(env: EnvMap, d):
    """Nearest-texel radiance for directions d (..., 3)."""
    eh, ew = env.prob_map.shape
    iy, ix = _texel_index(env, d)
    return env.texels.reshape(eh * ew, 3)[iy * ew + ix]


def _pdf_from_prob(env: EnvMap, prob, sin_theta):
    """Solid-angle pdf: sampling is uniform in (u, v) within a texel and
    dω = 2π² sinθ du dv, so p(ω) = prob·EhEw/(2π² sinθ) at the actual
    direction."""
    eh, ew = env.prob_map.shape
    p = prob * (eh * ew) / (
        2.0 * torch.pi * torch.pi * torch.clamp(sin_theta, min=1e-4))
    return torch.where(env.uniform > 0.5, _INV_4PI, p)


def pdf(env: EnvMap, d):
    """Solid-angle sampling pdf of :func:`sample` at directions d."""
    eh, ew = env.prob_map.shape
    iy, ix = _texel_index(env, d)
    prob = env.prob_map.reshape(-1)[iy * ew + ix]
    sin_theta = torch.sqrt(torch.clamp(1.0 - d[..., 1] * d[..., 1], min=0.0))
    return _pdf_from_prob(env, prob, sin_theta)


def cdf_index(cdf, u):
    """``sum(cdf < u)`` along the last axis of a non-decreasing ``cdf``
    (1-D, or 2-D with one row per ``u``) without an (R, L) compare."""
    return torch.searchsorted(cdf, u.contiguous(), side="left")


def _row_index(env: EnvMap, iy, u2):
    """``sum(cond_cdf[iy] < u2)`` for each ray, by one search of the rows
    laid end to end in float64 with row ``r`` shifted by ``2r``: rows below
    ``iy`` end below ``2·iy`` and rows above start at ``2·iy + 2``, so the
    count past ``iy·Ew`` is the row's own, exactly."""
    eh, ew = env.cond_cdf.shape
    shift = 2.0 * torch.arange(eh, dtype=torch.float64,
                               device=env.cond_cdf.device)
    flat = (env.cond_cdf.to(torch.float64) + shift[:, None]).reshape(-1)
    q = u2.to(torch.float64) + 2.0 * iy.to(torch.float64)
    return cdf_index(flat, q) - iy * ew


def sample(env: EnvMap, u1, u2):
    """Importance-sample directions ∝ luminance·sinθ from (R,) uniforms.
    Returns (directions (R, 3), solid-angle pdf (R,)). The CDF leftovers
    re-parameterise the position within the texel, so directions vary
    continuously with the uniforms."""
    eh, ew = env.prob_map.shape
    iy = torch.clamp(cdf_index(env.marg_cdf, u1), max=eh - 1)
    cdf_lo_y = torch.where(iy > 0, env.marg_cdf[torch.clamp(iy - 1, min=0)],
                           0.0)
    p_y = torch.clamp(env.marg_pdf[iy], min=1e-20)
    fy = torch.clamp((u1 - cdf_lo_y) / p_y, 0.0, 1.0 - 1e-6)

    ix = torch.clamp(_row_index(env, iy, u2), max=ew - 1)
    flat_cdf = env.cond_cdf.reshape(-1)
    row0 = iy * ew
    cdf_lo_x = torch.where(ix > 0, flat_cdf[row0 + torch.clamp(ix - 1,
                                                               min=0)], 0.0)
    p_x = torch.clamp(env.cond_pdf.reshape(-1)[row0 + ix], min=1e-20)
    fx = torch.clamp((u2 - cdf_lo_x) / p_x, 0.0, 1.0 - 1e-6)

    theta = (iy.to(torch.float32) + fy) / eh * torch.pi
    phi = ((ix.to(torch.float32) + fx) / ew - 0.5) * _TWO_PI
    st, ct = torch.sin(theta), torch.cos(theta)
    d = torch.stack([st * torch.cos(phi), ct, st * torch.sin(phi)], dim=-1)
    p = _pdf_from_prob(env, env.prob_map.reshape(-1)[row0 + ix], st)

    # Black map: the uniform sphere from the same two uniforms.
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi_u = _TWO_PI * u2
    d_uni = torch.stack([r * torch.cos(phi_u), z, r * torch.sin(phi_u)],
                        dim=-1)
    return torch.where(env.uniform > 0.5, d_uni, d), p


def sky_texels(width: int = 256, height: int = 128,
               sun_direction=(0.35, 0.65, 0.2),
               sun_radiance=(2500.0, 2300.0, 2000.0),
               sun_angular_radius: float = 0.00935,
               zenith=(0.20, 0.45, 1.0), horizon=(0.85, 0.90, 1.0),
               ground=(0.25, 0.22, 0.20), sky_scale: float = 1.0):
    """A simple analytic sun-sky baked into a (height, width, 3) lat-long
    grid in numpy: a zenith-to-horizon gradient, a smooth-edged sun disc
    (about 0.27° half-angle) four to five orders brighter than the sky,
    and a constant ground hemisphere."""
    sd = np.asarray(sun_direction, np.float64)
    sd = sd / np.linalg.norm(sd)
    v = (np.arange(height, dtype=np.float64) + 0.5) / height
    u = (np.arange(width, dtype=np.float64) + 0.5) / width
    theta = v * np.pi
    phi = (u - 0.5) * _TWO_PI
    st = np.sin(theta)[:, None]
    dirs = np.stack(
        [st * np.cos(phi)[None, :],
         np.broadcast_to(np.cos(theta)[:, None], (height, width)),
         st * np.sin(phi)[None, :]],
        axis=-1,
    )

    y = dirs[..., 1]
    t = np.clip(y, 0.0, 1.0) ** 0.45
    sky = ((1.0 - t[..., None]) * np.asarray(horizon)
           + t[..., None] * np.asarray(zenith)) * sky_scale
    grd = np.broadcast_to(np.asarray(ground), sky.shape) * sky_scale
    img = np.where(y[..., None] >= 0.0, sky, grd)

    cos_sun = np.clip((dirs * sd).sum(-1), -1.0, 1.0)
    ang = np.arccos(cos_sun)
    disc = np.clip(
        (sun_angular_radius - ang) / (0.25 * sun_angular_radius) + 1.0,
        0.0, 1.0,
    )
    img = img + disc[..., None] * np.asarray(sun_radiance)
    return img.astype(np.float32)


# --- Radiance .hdr (RGBE) IO -------------------------------------------
#
# Minimal self-contained reader/writer for the Radiance picture format
# (Ward's RGBE encoding): enough to load standard equirect HDR probes
# (both flat and adaptive-RLE scanlines) and to round-trip our own.


def _rgbe_encode(img: np.ndarray) -> np.ndarray:
    maxc = img.max(axis=-1)
    valid = maxc >= 1e-32
    m, e = np.frexp(np.maximum(maxc, 1e-32))
    exp = np.where(valid, e, 0)
    mant = np.where(valid, m, 0.0)
    scale = mant * 256.0 / np.maximum(maxc, 1e-32)
    rgbe = np.zeros(img.shape[:-1] + (4,), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(valid, exp + 128, 0).astype(np.uint8)
    return rgbe


def _rgbe_decode(rgbe: np.ndarray) -> np.ndarray:
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(
        exp > 0, np.ldexp(1.0, exp - 136).astype(np.float32), 0.0
    )
    # +0.5 mantissa centering (Ward's convention): halves the
    # truncation error of the 8-bit mantissa.
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]


def write_hdr(path: str, img) -> None:
    """Write (H, W, 3) linear radiance as a flat-scanline .hdr file."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(_rgbe_encode(img).tobytes())


def load_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file → (H, W, 3) f32 linear radiance."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    pos = data.index(b"\n\n") + 2
    eol = data.index(b"\n", pos)
    dims = data[pos:eol].split()
    if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {dims}")
    h, w = int(dims[1]), int(dims[3])
    body = np.frombuffer(data, np.uint8, offset=eol + 1)

    # Flat scanlines?
    if body.size == h * w * 4:
        first = body[:4]
        if not (first[0] == 2 and first[1] == 2 and
                (int(first[2]) << 8 | int(first[3])) == w):
            return _rgbe_decode(body.reshape(h, w, 4))
    # Adaptive RLE scanlines (each starts 0x02 0x02 w_hi w_lo).
    out = np.empty((h, w, 4), np.uint8)
    p = 0
    for row in range(h):
        if p + 4 > body.size:
            raise ValueError(f"{path}: truncated at scanline {row}")
        hdr4 = body[p:p + 4]
        if not (hdr4[0] == 2 and hdr4[1] == 2):
            # Old-style flat remainder.
            rest = body[p:]
            need = (h - row) * w * 4
            if rest.size < need:
                raise ValueError(f"{path}: truncated flat data")
            out[row:] = rest[:need].reshape(h - row, w, 4)
            return _rgbe_decode(out)
        if (int(hdr4[2]) << 8 | int(hdr4[3])) != w:
            raise ValueError(f"{path}: scanline width mismatch")
        p += 4
        for c in range(4):
            col = 0
            while col < w:
                n = int(body[p])
                if n > 128:  # run
                    out[row, col:col + n - 128, c] = body[p + 1]
                    col += n - 128
                    p += 2
                else:        # literal
                    out[row, col:col + n, c] = body[p + 1:p + 1 + n]
                    col += n
                    p += 1 + n
    return _rgbe_decode(out)


def environment_texels(spec, base_dir: str = ".") -> np.ndarray:
    """The (H, W, 3) radiance grid of a scene file's ``environment`` entry,
    one of:

      {"image": "probe.hdr", "scale": 1.0, "rotate_degrees": 0}
      {"sky": {...sky_texels kwargs...}}
      {"uniform": [r, g, b], "resolution": [h, w]}

    A relative image path resolves against ``base_dir``."""
    scale = float(spec.get("scale", 1.0))
    if "image" in spec:
        path = spec["image"]
        if not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        tx = load_hdr(path) * scale
    elif "sky" in spec:
        tx = sky_texels(**spec["sky"]) * scale
    elif "uniform" in spec:
        h, w = spec.get("resolution", (16, 32))
        tx = np.broadcast_to(
            np.asarray(spec["uniform"], np.float32), (int(h), int(w), 3)
        ).copy() * scale
    else:
        raise ValueError(f"unknown environment spec: {spec}")
    rot = float(spec.get("rotate_degrees", 0.0))
    if rot:
        shift = int(round(rot / 360.0 * tx.shape[1])) % tx.shape[1]
        tx = np.roll(tx, shift, axis=1)
    return tx


def load_environment(spec, base_dir: str = ".",
                     device=None) -> Optional[EnvMap]:
    """An EnvMap on ``device`` (the card unless the caller asks for another
    device) from a scene file's ``environment`` entry
    (``environment_texels``); None for None."""
    if spec is None:
        return None
    return build_envmap(environment_texels(spec, base_dir),
                        resolve_device(device))
