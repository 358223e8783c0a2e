"""Tonemapping and PNG output (the JAX package's ``utils/image.py``): a
device-side tonemap to uint8 sRGB, one device→host copy, and a stdlib
(zlib + struct) PNG encoder."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

M32 = 0xFFFFFFFF


def linear_to_srgb(rgb):
    """IEC 61966-2-1 opto-electronic transfer."""
    rgb = torch.clamp(rgb, 0.0, 1.0)
    lo = rgb * 12.92
    hi = 1.055 * torch.pow(torch.clamp(rgb, min=1e-7), 1.0 / 2.4) - 0.055
    return torch.where(rgb <= 0.0031308, lo, hi)


def aces_film(rgb):
    """ACES filmic curve (Narkowicz 2015 fit)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    rgb = torch.clamp(rgb, min=0.0)
    return torch.clamp((rgb * (a * rgb + b)) / (rgb * (c * rgb + d) + e),
                       0.0, 1.0)


def reinhard(rgb):
    """Luminance-ratio Reinhard: L/(1+L), hue-preserving."""
    rgb = torch.clamp(rgb, min=0.0)
    lum = (0.2126 * rgb[..., 0:1] + 0.7152 * rgb[..., 1:2]
           + 0.0722 * rgb[..., 2:3])
    return torch.clamp(rgb / (1.0 + lum), 0.0, 1.0)


def filmic_hable(rgb):
    """Hable "Uncharted 2" curve, white point 11.2."""
    A, B, C, D, E, F = 0.15, 0.50, 0.20, 0.20, 0.02, 0.30

    def curve(x):
        return ((x * (A * x + C * B) + D * E)
                / (x * (A * x + B) + D * F)) - E / F

    rgb = torch.clamp(rgb, min=0.0)
    white = curve(torch.tensor(11.2, dtype=torch.float32, device=rgb.device))
    return torch.clamp(curve(2.0 * rgb) / white, 0.0, 1.0)


_CURVES = {"aces": aces_film, "reinhard": reinhard, "filmic": filmic_hable}


def tonemap(linear_rgb, exposure=1.0, curve: str = "clip"):
    """Linear HDR radiance → uint8 sRGB on the tensor's device. ``curve``
    is "clip", "aces", "reinhard" or "filmic"; quantization is dithered
    with a deterministic per-pixel hash so smooth gradients do not band."""
    linear_rgb = linear_rgb * exposure
    if curve in _CURVES:
        linear_rgb = _CURVES[curve](linear_rgb)
    srgb = linear_to_srgb(linear_rgb)
    if srgb.ndim == 3:
        h, w, c = srgb.shape
        dev = srgb.device
        ys = torch.arange(h, dtype=torch.int64, device=dev)[:, None, None]
        xs = torch.arange(w, dtype=torch.int64, device=dev)[None, :, None]
        cs = torch.arange(c, dtype=torch.int64, device=dev)[None, None, :]
        key = (((ys * 0x9E3779B1) & M32) ^ ((xs * 0x85EBCA77) & M32)
               ^ ((cs * 0xC2B2AE3D) & M32))
        key = key ^ (key >> 15)
        key = (key * 0x2C1B3C6D) & M32
        key = key ^ (key >> 12)
        dither = (key & 0xFFFF).to(torch.float32) / 65536.0
    else:
        dither = 0.5
    return torch.clamp(srgb * 255.0 + dither, 0.0, 255.0).to(torch.uint8)


def encode_png(rgb8: np.ndarray) -> bytes:
    """Minimal RGB8 PNG encoder (stdlib only). rgb8: (H, W, 3) uint8."""
    rgb8 = np.asarray(rgb8, np.uint8)
    h, w, c = rgb8.shape
    if c != 3:
        raise ValueError("encode_png expects (H, W, 3) uint8")

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    raw = b"".join(b"\x00" + rgb8[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, linear_rgb, exposure=1.0,
              curve: str = "clip") -> None:
    """Tonemap on the device, copy once to the host, encode, write."""
    rgb8 = tonemap(linear_rgb, exposure, curve).cpu().numpy()
    with open(path, "wb") as f:
        f.write(encode_png(rgb8))
