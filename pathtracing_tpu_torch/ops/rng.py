"""Counter-based RNG, bit-exact with the JAX package's ``ops/rng.py``.

Keys derive purely from ``(seed, pixel_index, sample_index, bounce, use)``
counters via Threefry-2x32 ``fold_in``, as ``jax.random`` computes them
with ``jax_threefry_partitionable=True``:

  * ``key(seed)``      = (seed >> 32, seed & 0xFFFFFFFF)
  * ``fold_in(k, x)``  = threefry2x32(k, (0, x))
  * ``uniform(k, n)``  : bits_i = xor of threefry2x32(k, (0, i)), i < n;
                         u = bitcast_f32((bits >> 9) | 0x3F800000) - 1

A key is an int64 tensor of shape (..., 2) holding two 32-bit words.
All 32-bit arithmetic runs in int64 masked to 32 bits: torch's uint32
shifts and rotates are thin, especially on CUDA.

The low-discrepancy part (``ld_scalar``/``ld_pair``) is the JAX package's
per-stream-prime Halton sequence with a per-(pixel, stream) rotation.
"""

from __future__ import annotations

import numpy as np
import torch

from pathtracing_tpu_torch.utils import metrics

M32 = 0xFFFFFFFF

# Stream tags — the JAX package's constants, so both draw the same streams.
STREAM_PIXEL_JITTER = 0x9E37
STREAM_LENS = 0x7F4A
STREAM_SCATTER = 0x85EB
STREAM_RR = 0xC2B2
STREAM_NEE = 0x5BD1
STREAM_ENV = 0x68E3
STREAM_TIME = 0x2B7E
STREAM_FOG = 0x3C6F
STREAM_DELTA = 0x51A3
STREAM_VOL = 0x6B43
STREAM_VOLT = 0x1F83
STREAM_SSS = 0x4D2B
_LD_SCALAR_SALT = 0x27D4

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# The span of the public entries below: the host's issue of the
# generator's ops (``utils.metrics``).
SPAN = "shade.rng"


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) over broadcastable int64 word tensors."""
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


def _words(x, device):
    if not torch.is_tensor(x):
        x = metrics.to_device("rng.words", int(x), torch.int64, device)
    return x.to(torch.int64) & M32


@metrics.traced(SPAN)
def key(seed, device=None):
    """``jax.random.key(seed)`` as a (2,) int64 word pair."""
    s = int(seed)
    return metrics.to_device("rng.key", [(s >> 32) & M32, s & M32],
                             torch.int64, device)


@metrics.traced(SPAN)
def fold_in(k, data):
    """``jax.random.fold_in`` broadcast over a key batch and/or a data batch
    (``data`` an int, or an integer tensor; negative ints wrap as uint32)."""
    d = _words(data, k.device)
    o0, o1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


@metrics.traced(SPAN)
def random_bits(k, n=None):
    """32-bit words of ``jax.random.bits(k, shape)``: shape () when ``n`` is
    None (returns k.shape[:-1]) else (n,) (returns k.shape[:-1] + (n,))."""
    if n is None:
        c = torch.zeros((), dtype=torch.int64, device=k.device)
        k0, k1 = k[..., 0], k[..., 1]
    else:
        c = torch.arange(n, dtype=torch.int64, device=k.device)
        k0, k1 = k[..., 0:1], k[..., 1:2]
    o0, o1 = threefry2x32(k0, k1, torch.zeros_like(c), c)
    return o0 ^ o1


@metrics.traced(SPAN)
def uniform(k, n=None):
    """``jax.random.uniform(k, shape, float32)`` in [0, 1), bit-exact."""
    bits = (random_bits(k, n) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


@metrics.traced(SPAN)
def pixel_sample_key(seed, pixel_index, sample_index):
    """Key for each (pixel, sample) pair; ``pixel_index`` is a tensor of
    flat row-major pixel ids, ``sample_index`` the global sample counter
    (an int or a tensor)."""
    k = key(seed, pixel_index.device)
    return fold_in(fold_in(k, pixel_index), sample_index)


@metrics.traced(SPAN)
def stream_key(k, bounce, stream_tag):
    """Sub-key for one RNG consumer at one bounce."""
    return fold_in(fold_in(k, bounce), stream_tag)


# --- Progressive low-discrepancy sampling (see the JAX module) ----------


def _bitrev32(n):
    n = ((n >> 1) & 0x55555555) | ((n & 0x55555555) << 1)
    n = ((n >> 2) & 0x33333333) | ((n & 0x33333333) << 2)
    n = ((n >> 4) & 0x0F0F0F0F) | ((n & 0x0F0F0F0F) << 4)
    n = ((n >> 8) & 0x00FF00FF) | ((n & 0x00FF00FF) << 8)
    return ((n >> 16) | (n << 16)) & M32


_VDC_DIGITS = {3: 21, 5: 14, 7: 12, 11: 10, 13: 9, 17: 8, 19: 8,
               23: 8, 29: 7}


def _vdc(s, base: int):
    """Base-``base`` radical inverse of a uint32 index tensor (float32
    arithmetic in the JAX package's order)."""
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
_LD_SCALAR_BASES = {
    STREAM_NEE: 11,
    STREAM_TIME: 29,
}


def _index(sample_index, device):
    if torch.is_tensor(sample_index):
        return sample_index.to(device)
    return metrics.to_device("rng.index", int(sample_index), torch.int64,
                             device)


@metrics.traced(SPAN)
def ld_scalar(seed, pixel_index, sample_index, stream_tag):
    """Stratified 1D sample: van der Corput in the stream's own prime base
    plus a per-(seed, pixel, stream) rotation. Shape of ``pixel_index``
    broadcast with ``sample_index``."""
    k = fold_in(fold_in(fold_in(key(seed, pixel_index.device), pixel_index),
                        stream_tag), _LD_SCALAR_SALT)
    rot = uniform(k)
    s = _index(sample_index, pixel_index.device)
    u = _vdc(s, _LD_SCALAR_BASES[stream_tag]) + rot
    return u - torch.floor(u)


@metrics.traced(SPAN)
def ld_pair(seed, pixel_index, sample_index, stream_tag):
    """Stratified 2D sample: the stream's Halton prime pair at
    ``sample_index`` with a per-(seed, pixel, stream) rotation."""
    b0, b1 = _LD_PAIR_BASES[stream_tag]
    k = fold_in(fold_in(key(seed, pixel_index.device), pixel_index),
                stream_tag)
    rot = uniform(k, 2)
    s = _index(sample_index, pixel_index.device)
    u0 = _vdc(s, b0) + rot[..., 0]
    u1 = _vdc(s, b1) + rot[..., 1]
    return u0 - torch.floor(u0), u1 - torch.floor(u1)
