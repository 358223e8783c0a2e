"""Tonemapping and image output (the JAX package's ``utils/image.py``): a
device-side tonemap to uint8 sRGB, one device→host copy, a stdlib
(zlib + struct) PNG encoder and decoder, and a writer that picks the
format by extension (PNG, PPM, linear Radiance ``.hdr`` or OpenEXR)."""

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


def decode_png(data: bytes) -> np.ndarray:
    """Minimal decoder for images made by ``encode_png``: 8-bit RGB, filter
    0 scanlines. Returns (H, W, 3) uint8."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG stream")
    pos = 8
    w = h = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color, *_ = struct.unpack(">IIBBBBB", payload)
            if depth != 8 or color != 2:
                raise ValueError("decode_png supports RGB8 only")
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3 + 1
    rows = []
    for y in range(h):
        row = raw[y * stride:(y + 1) * stride]
        if row[0] != 0:
            raise ValueError("decode_png supports filter 0 only")
        rows.append(np.frombuffer(row[1:], np.uint8))
    return np.stack(rows).reshape(h, w, 3)


def _host(linear_rgb) -> np.ndarray:
    if isinstance(linear_rgb, torch.Tensor):
        return linear_rgb.detach().cpu().numpy()
    return np.asarray(linear_rgb)


def _tensor(linear_rgb) -> torch.Tensor:
    if isinstance(linear_rgb, torch.Tensor):
        return linear_rgb
    return torch.as_tensor(np.asarray(linear_rgb, np.float32))


def write_image(path: str, linear_rgb, exposure=1.0,
                curve: str = "clip") -> None:
    """Write by extension: ``.hdr`` linear Radiance RGBE (exposure applied,
    no tone curve), ``.exr`` linear float32 OpenEXR, ``.ppm`` a plain
    raster, anything else a tonemapped PNG."""
    low = path.lower()
    if low.endswith(".hdr"):
        from pathtracing_tpu_torch.ops.envmap import write_hdr

        write_hdr(path, _host(linear_rgb)[..., :3] * float(exposure))
    elif low.endswith(".exr"):
        from pathtracing_tpu_torch.utils.exr import write_exr

        write_exr(path, _host(linear_rgb)[..., :3] * float(exposure))
    elif low.endswith(".ppm"):
        write_ppm(path, linear_rgb)
    else:
        write_png(path, _tensor(linear_rgb), exposure, curve)


def write_ppm(path: str, linear_rgb) -> None:
    """Plain PPM (P6): the zero-dependency raster."""
    rgb8 = tonemap(_tensor(linear_rgb)).cpu().numpy()
    h, w, _ = rgb8.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(rgb8.tobytes())


def rmse(a, b) -> float:
    """Per-pixel RMSE between two linear images, in float64."""
    a = np.asarray(_host(a), np.float64)
    b = np.asarray(_host(b), np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
