"""Frozen copy of the port's sample streams (``ops/rng.py`` of the port,
which is the JAX package's ``jax.random`` threefry and LD sampler bit for
bit), so that the reference draws each (pixel, sample, bounce) path's
numbers as the program does. Integer arithmetic in int64 masked to 32
bits; the floats come out as float32."""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF

STREAM_PIXEL_JITTER = 0x9E37
STREAM_LENS = 0x7F4A
STREAM_SCATTER = 0x85EB
STREAM_NEE = 0x5BD1
_LD_SCALAR_SALT = 0x27D4
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, over broadcastable int64 word tensors."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def key(seed, device):
    s = int(seed)
    return torch.tensor([(s >> 32) & M32, s & M32], dtype=torch.int64,
                        device=device)


def fold_in(k, data):
    """``jax.random.fold_in`` over a key batch and/or a data batch."""
    if not torch.is_tensor(data):
        data = torch.tensor(int(data), dtype=torch.int64, device=k.device)
    d = data.to(torch.int64) & M32
    o0, o1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def uniform(k, n=None):
    """``jax.random.uniform`` float32 in [0, 1): shape k.shape[:-1] when
    ``n`` is None, else k.shape[:-1] + (n,). Word i of a draw depends on
    i alone, so the first n of a longer draw are these."""
    if n is None:
        c = torch.zeros((), dtype=torch.int64, device=k.device)
        k0, k1 = k[..., 0], k[..., 1]
    else:
        c = torch.arange(n, dtype=torch.int64, device=k.device)
        k0, k1 = k[..., 0:1], k[..., 1:2]
    o0, o1 = threefry2x32(k0, k1, torch.zeros_like(c), c)
    bits = ((o0 ^ o1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def pixel_sample_key(seed, pixel, sample):
    return fold_in(fold_in(key(seed, pixel.device), pixel), sample)


def _bitrev32(n):
    n = ((n >> 1) & 0x55555555) | ((n & 0x55555555) << 1)
    n = ((n >> 2) & 0x33333333) | ((n & 0x33333333) << 2)
    n = ((n >> 4) & 0x0F0F0F0F) | ((n & 0x0F0F0F0F) << 4)
    n = ((n >> 8) & 0x00FF00FF) | ((n & 0x00FF00FF) << 8)
    return ((n >> 16) | (n << 16)) & M32


_VDC_DIGITS = {3: 21, 5: 14, 7: 12, 11: 10, 13: 9, 17: 8, 19: 8,
               23: 8, 29: 7}


def _vdc(s, base: int):
    """Radical inverse of a uint32 index in ``base``, float32 in the
    sampler's own order."""
    n = s.to(torch.int64) & M32
    if base == 2:
        return _bitrev32(n).to(torch.float32) * (2.0 ** -32)
    r = torch.zeros(n.shape, dtype=torch.float32, device=n.device)
    inv = np.float32(1.0 / base)
    scale = inv
    for _ in range(_VDC_DIGITS[base]):
        r = r + (n % base).to(torch.float32) * float(scale)
        n = n // base
        scale = np.float32(scale * inv)
    return r


_LD_PAIR_BASES = {
    STREAM_PIXEL_JITTER: (2, 3),
    STREAM_LENS: (5, 7),
    STREAM_NEE: (13, 17),
    STREAM_SCATTER: (19, 23),
}
_LD_SCALAR_BASES = {STREAM_NEE: 11}


def ld_scalar(seed, pixel, sample, tag):
    """Rotated van der Corput draw of stream ``tag``."""
    k = fold_in(fold_in(fold_in(key(seed, pixel.device), pixel), tag),
                _LD_SCALAR_SALT)
    u = _vdc(sample, _LD_SCALAR_BASES[tag]) + uniform(k)
    return u - torch.floor(u)


def ld_pair(seed, pixel, sample, tag):
    """Rotated Halton pair of stream ``tag``."""
    b0, b1 = _LD_PAIR_BASES[tag]
    rot = uniform(fold_in(fold_in(key(seed, pixel.device), pixel), tag), 2)
    u0 = _vdc(sample, b0) + rot[..., 0]
    u1 = _vdc(sample, b1) + rot[..., 1]
    return u0 - torch.floor(u0), u1 - torch.floor(u1)
