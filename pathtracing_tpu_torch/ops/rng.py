"""Counter-based RNG, bit-exact with the JAX package's ``ops/rng.py``.

Keys derive purely from ``(seed, pixel_index, sample_index, bounce, use)``
counters via Threefry-2x32 ``fold_in``, as ``jax.random`` computes them
with ``jax_threefry_partitionable=True``:

  * ``key(seed)``      = (seed >> 32, seed & 0xFFFFFFFF)
  * ``fold_in(k, x)``  = threefry2x32(k, (0, x))
  * ``uniform(k, n)``  : bits_i = xor of threefry2x32(k, (0, i)), i < n;
                         u = bitcast_f32((bits >> 9) | 0x3F800000) - 1

A key is an int64 tensor of shape (..., 2) holding two 32-bit words.

The low-discrepancy part (``ld_scalar``/``ld_pair``) is the JAX package's
per-stream-prime Halton sequence with a per-(seed, pixel, stream)
rotation.

Two routes, chosen by the device of the input tensor (for ``key``, of
``device``); both give the same bits:

  * CPU tensors take the plain version (the ``*_torch`` functions): every
    32-bit step an int64 torch op masked to 32 bits (torch's uint32
    shifts and rotates are thin), Python ints copied in as tensors
    (``metrics.to_device``).
  * CUDA tensors launch the kernels of ``csrc/rng.cu``, one a public
    entry, each doing its whole chain per lane in registers in native
    uint32: ``fold_kernel`` (``key``, ``fold_in``, ``stream_key``,
    ``pixel_sample_key``), ``bits_kernel`` (``random_bits``,
    ``uniform``), ``ld_kernel`` (``ld_scalar``, ``ld_pair``). Python ints
    (seeds, tags, bounces, sample counters) are launch arguments, so no
    entry copies to the card or waits for it. Each launch is a
    ``rng.launch`` span inside ``shade.rng`` (``utils.metrics``) and adds
    one to ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from pathtracing_tpu_torch.ops import cuda_build
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
# The span of one kernel launch (CUDA tensors), nested in ``SPAN``.
LAUNCH_SPAN = "rng.launch"
# Launch counts of the kernels, by kernel (``fold_kernel``, ...).
LAUNCHES = {"fold": 0, "bits": 0, "ld": 0}


# --- The plain version (CPU tensors) ----------------------------------------


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


def key_torch(seed, device=None):
    """Plain version of ``key``."""
    s = int(seed)
    return metrics.to_device("rng.key", [(s >> 32) & M32, s & M32],
                             torch.int64, device)


def fold_in_torch(k, data):
    """Plain version of ``fold_in``."""
    d = _words(data, k.device)
    o0, o1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def random_bits_torch(k, n=None):
    """Plain version of ``random_bits``."""
    if n is None:
        c = torch.zeros((), dtype=torch.int64, device=k.device)
        k0, k1 = k[..., 0], k[..., 1]
    else:
        c = torch.arange(n, dtype=torch.int64, device=k.device)
        k0, k1 = k[..., 0:1], k[..., 1:2]
    o0, o1 = threefry2x32(k0, k1, torch.zeros_like(c), c)
    return o0 ^ o1


def uniform_torch(k, n=None):
    """Plain version of ``uniform``."""
    bits = (random_bits_torch(k, n) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def pixel_sample_key_torch(seed, pixel_index, sample_index):
    """Plain version of ``pixel_sample_key``."""
    k = key_torch(seed, pixel_index.device)
    return fold_in_torch(fold_in_torch(k, pixel_index), sample_index)


def stream_key_torch(k, bounce, stream_tag):
    """Plain version of ``stream_key``."""
    return fold_in_torch(fold_in_torch(k, bounce), stream_tag)


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


def ld_scalar_torch(seed, pixel_index, sample_index, stream_tag):
    """Plain version of ``ld_scalar``."""
    k = fold_in_torch(fold_in_torch(fold_in_torch(
        key_torch(seed, pixel_index.device), pixel_index), stream_tag),
        _LD_SCALAR_SALT)
    rot = uniform_torch(k)
    s = _index(sample_index, pixel_index.device)
    u = _vdc(s, _LD_SCALAR_BASES[stream_tag]) + rot
    return u - torch.floor(u)


def ld_pair_torch(seed, pixel_index, sample_index, stream_tag):
    """Plain version of ``ld_pair``."""
    b0, b1 = _LD_PAIR_BASES[stream_tag]
    k = fold_in_torch(fold_in_torch(key_torch(seed, pixel_index.device),
                                    pixel_index), stream_tag)
    rot = uniform_torch(k, 2)
    s = _index(sample_index, pixel_index.device)
    u0 = _vdc(s, b0) + rot[..., 0]
    u1 = _vdc(s, b1) + rot[..., 1]
    return u0 - torch.floor(u0), u1 - torch.floor(u1)


# --- The kernels (CUDA tensors) ---------------------------------------------

_P, _I, _U, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, \
    ctypes.c_longlong
_WORD = [_P, _I, _I, _U]     # ptr, is64, stride, value
_SIGNATURES = {
    # key, key_stride, key0, key1, n_folds, d0, d1, d2, lanes, out, stream
    "ptpu_rng_fold": [_P, _I, _U, _U, _I, *_WORD, *_WORD, *_WORD, _LL, _P,
                      _P],
    # key, key_stride, lanes, n, as_uniform, out, stream
    "ptpu_rng_bits": [_P, _I, _LL, _I, _I, _P, _P],
    # seed0, seed1, pixel, tag, salted, salt, sample, base0, base1, lanes,
    # out0, out1, stream
    "ptpu_rng_ld": [_U, _U, *_WORD, _U, _I, _U, *_WORD, _I, _I, _LL, _P, _P,
                    _P],
}
_NO_WORD = (None, 0, 0, 0)


def _on_card(device) -> bool:
    """Whether tensors on ``device`` take the kernels (CUDA) or the plain
    version."""
    return device is not None and torch.device(device).type == "cuda"


def _seed_words(seed):
    s = int(seed)
    return (s >> 32) & M32, s & M32


def _launch(fn: str, device, *args) -> None:
    lib = cuda_build.load("rng", _SIGNATURES)
    with metrics.span(LAUNCH_SPAN):
        err = getattr(lib, fn)(*args,
                               torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES[fn[len("ptpu_rng_"):]] += 1
    if err != 0:
        raise RuntimeError(f"{fn} launch failed with CUDA error {err}")


def _shape_of(x):
    return tuple(x.shape) if torch.is_tensor(x) else ()


def _broadcast(*shapes):
    """The broadcast of ``shapes``, as torch broadcasts tensors.
    (``torch.broadcast_shapes`` imports sympy on its first call, seconds
    of a process's set-up.)"""
    out = []
    for dims in zip(*(((1,) * (max(map(len, shapes)) - len(s)) + tuple(s))
                      for s in shapes)):
        sizes = {d for d in dims if d != 1}
        if len(sizes) > 1:
            raise ValueError(f"shapes {shapes} do not broadcast")
        out.append(sizes.pop() if sizes else 1)
    return tuple(out)


def _word(x, shape, device):
    """(``Word`` arguments, the tensor to keep alive) of an integer operand
    over a lane grid of ``shape``: an int (a launch argument), a tensor of
    one element (read once) or one of ``shape`` (read per lane)."""
    if not torch.is_tensor(x):
        return (None, 0, 0, int(x) & M32), None
    if x.device != device:
        if x.device.type == "cpu" and x.numel() == 1:
            return (None, 0, 0, int(x.reshape(())) & M32), None
        x = x.to(device)
    if x.dtype not in (torch.int32, torch.int64):
        x = x.to(torch.int64)
    if x.numel() == 1:
        return (x.data_ptr(), int(x.dtype == torch.int64), 0, 0), x
    if tuple(x.shape) != shape:
        x = x.expand(shape)
    x = x.contiguous()
    return (x.data_ptr(), int(x.dtype == torch.int64), 1, 0), x


def _key_src(k, shape):
    """(key pointer, stride, the tensor to keep alive) of a key batch over
    a lane grid of ``shape``."""
    k = k.to(torch.int64)
    if math.prod(k.shape[:-1]) == 1:
        k = k.contiguous()
        return k.data_ptr(), 0, k
    if tuple(k.shape[:-1]) != shape:
        k = k.expand(*shape, 2)
    k = k.contiguous()
    return k.data_ptr(), 1, k


def _fold_kernel(k, datas, device, seed=None):
    """``fold_in`` of each of ``datas`` in turn (at most three) on the key
    batch ``k``, or on ``key(seed)`` when ``k`` is None; one launch."""
    shape = _broadcast((), *([] if k is None else [k.shape[:-1]]),
                       *(_shape_of(d) for d in datas))
    out = torch.empty((*shape, 2), dtype=torch.int64, device=device)
    lanes = math.prod(shape)
    if lanes == 0:
        return out
    if k is None:
        key_args, keep = (None, 0, *_seed_words(seed)), []
    else:
        ptr, stride, kk = _key_src(k, shape)
        key_args, keep = (ptr, stride, 0, 0), [kk]
    words = []
    for d in datas:
        w, t = _word(d, shape, device)
        words += w
        keep.append(t)
    words += _NO_WORD * (3 - len(datas))
    _launch("ptpu_rng_fold", device, *key_args, len(datas), *words, lanes,
            out.data_ptr())
    return out


def _bits_kernel(k, n, as_uniform):
    batch = tuple(k.shape[:-1])
    count = 1 if n is None else int(n)
    shape = batch if n is None else (*batch, count)
    out = torch.empty(shape, device=k.device,
                      dtype=torch.float32 if as_uniform else torch.int64)
    lanes = math.prod(batch)
    if out.numel() == 0:
        return out
    ptr, stride, _keep = _key_src(k, batch)
    _launch("ptpu_rng_bits", k.device, ptr, stride, lanes, count,
            int(as_uniform), out.data_ptr())
    return out


def _ld_kernel(seed, pixel_index, sample_index, stream_tag, bases, salted):
    dev = pixel_index.device
    shape = _broadcast(pixel_index.shape, _shape_of(sample_index))
    outs = [torch.empty(shape, dtype=torch.float32, device=dev)
            for _ in bases]
    lanes = math.prod(shape)
    if lanes == 0:
        return outs
    pix, _keep_pix = _word(pixel_index, shape, dev)
    sample, _keep_sample = _word(sample_index, shape, dev)
    b0, b1 = (*bases, 0)[:2]
    _launch("ptpu_rng_ld", dev, *_seed_words(seed), *pix,
            int(stream_tag) & M32, int(salted), _LD_SCALAR_SALT, *sample,
            b0, b1, lanes, outs[0].data_ptr(),
            outs[1].data_ptr() if len(outs) > 1 else None)
    return outs


# --- The public entries -----------------------------------------------------


@metrics.traced(SPAN)
def key(seed, device=None):
    """``jax.random.key(seed)`` as a (2,) int64 word pair."""
    if _on_card(device):
        return _fold_kernel(None, (), torch.device(device), seed=seed)
    return key_torch(seed, device)


@metrics.traced(SPAN)
def fold_in(k, data):
    """``jax.random.fold_in`` broadcast over a key batch and/or a data batch
    (``data`` an int, or an integer tensor; negative ints wrap as uint32)."""
    if _on_card(k.device):
        return _fold_kernel(k, (data,), k.device)
    return fold_in_torch(k, data)


@metrics.traced(SPAN)
def random_bits(k, n=None):
    """32-bit words of ``jax.random.bits(k, shape)``: shape () when ``n`` is
    None (returns k.shape[:-1]) else (n,) (returns k.shape[:-1] + (n,))."""
    if _on_card(k.device):
        return _bits_kernel(k, n, as_uniform=False)
    return random_bits_torch(k, n)


@metrics.traced(SPAN)
def uniform(k, n=None):
    """``jax.random.uniform(k, shape, float32)`` in [0, 1), bit-exact."""
    if _on_card(k.device):
        return _bits_kernel(k, n, as_uniform=True)
    return uniform_torch(k, n)


@metrics.traced(SPAN)
def pixel_sample_key(seed, pixel_index, sample_index):
    """Key for each (pixel, sample) pair; ``pixel_index`` is a tensor of
    flat row-major pixel ids, ``sample_index`` the global sample counter
    (an int or a tensor)."""
    if _on_card(pixel_index.device):
        return _fold_kernel(None, (pixel_index, sample_index),
                            pixel_index.device, seed=seed)
    return pixel_sample_key_torch(seed, pixel_index, sample_index)


@metrics.traced(SPAN)
def stream_key(k, bounce, stream_tag):
    """Sub-key for one RNG consumer at one bounce."""
    if _on_card(k.device):
        return _fold_kernel(k, (bounce, stream_tag), k.device)
    return stream_key_torch(k, bounce, stream_tag)


@metrics.traced(SPAN)
def ld_scalar(seed, pixel_index, sample_index, stream_tag):
    """Stratified 1D sample: van der Corput in the stream's own prime base
    plus a per-(seed, pixel, stream) rotation. Shape of ``pixel_index``
    broadcast with ``sample_index``."""
    if _on_card(pixel_index.device):
        return _ld_kernel(seed, pixel_index, sample_index, stream_tag,
                          (_LD_SCALAR_BASES[stream_tag],), salted=True)[0]
    return ld_scalar_torch(seed, pixel_index, sample_index, stream_tag)


@metrics.traced(SPAN)
def ld_pair(seed, pixel_index, sample_index, stream_tag):
    """Stratified 2D sample: the stream's Halton prime pair at
    ``sample_index`` with a per-(seed, pixel, stream) rotation."""
    if _on_card(pixel_index.device):
        return tuple(_ld_kernel(seed, pixel_index, sample_index, stream_tag,
                                _LD_PAIR_BASES[stream_tag], salted=False))
    return ld_pair_torch(seed, pixel_index, sample_index, stream_tag)
