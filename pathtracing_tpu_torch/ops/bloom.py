"""Bloom post-process (the JAX package's ``ops/bloom.py``): a soft-knee
bright pass and a binomial mip pyramid, added back in linear radiance
before the tone curve.

The image is edge-padded to a multiple of ``2^levels``; the bright pass
runs ``levels`` times through a separable 5-tap binomial blur and a 2x
decimation, then the chain comes back up, each level bilinearly
upsampled, blurred and added to the next finer one. The sum is divided by
the level count, so ``strength`` has a scale-free meaning.
"""

from __future__ import annotations

import torch

_KERNEL5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _edge_index(n: int, lo: int, hi: int, device):
    return torch.clamp(torch.arange(-lo, n + hi, device=device), 0, n - 1)


def _blur5(img):
    """Separable 5-tap binomial blur of (H, W, C), edge-replicated."""
    h, w = img.shape[0], img.shape[1]
    pad = img[_edge_index(h, 2, 2, img.device)]
    img = sum(k * pad[i:i + h] for i, k in enumerate(_KERNEL5))
    pad = img[:, _edge_index(w, 2, 2, img.device)]
    return sum(k * pad[:, i:i + w] for i, k in enumerate(_KERNEL5))


def _upsample2_axis(img, axis: int):
    """2x linear upsampling along ``axis`` with half-pixel centres
    (``jax.image.resize(method="linear")``): output 2i takes 1/4 of input
    i-1 and 3/4 of input i, output 2i+1 3/4 of input i and 1/4 of input
    i+1; at the two ends the outside tap drops and the weights
    renormalize to the edge value."""
    n = img.shape[axis]
    x = img.movedim(axis, 0)
    prev = x[_edge_index(n, 1, 0, img.device)[:n]]
    nxt = x[_edge_index(n, 0, 1, img.device)[1:]]
    even = 0.25 * prev + 0.75 * x
    odd = 0.75 * x + 0.25 * nxt
    even[0] = x[0]
    odd[-1] = x[-1]
    out = torch.stack([even, odd], dim=1).reshape((2 * n,) + x.shape[1:])
    return out.movedim(0, axis)


def _upsample2(img):
    """Bilinear 2x upsample of (H, W, C)."""
    return _upsample2_axis(_upsample2_axis(img, 0), 1)


def _bright_pass(img, threshold: float, knee: float):
    """Soft-knee high-pass: full contribution above ``threshold``, a
    quadratic ramp over [threshold - knee, threshold], zero below; scales
    the colour, so hue is kept."""
    lum = (0.2126 * img[..., 0] + 0.7152 * img[..., 1]
           + 0.0722 * img[..., 2])
    knee = max(knee, 1e-4)
    soft = torch.clamp(lum - threshold + knee, 0.0, 2.0 * knee)
    soft = soft * soft / (4.0 * knee)
    weight = torch.maximum(soft, lum - threshold) / torch.clamp(lum,
                                                                min=1e-6)
    return img * weight[..., None]


def num_levels(height: int, width: int, cap: int = 6) -> int:
    """Pyramid depth: halve until the short side would drop under ~8 px."""
    side = min(height, width)
    n = 0
    while side >= 16 and n < cap:
        side //= 2
        n += 1
    return max(n, 1)


def bloom_layer(img, threshold: float = 1.0, knee: float = 0.5,
                levels: int | None = None):
    """The normalized glow layer (same shape as ``img``), not yet scaled
    or added: callers do ``img + strength * bloom_layer(img)``."""
    h, w, _ = img.shape
    if levels is None:
        levels = num_levels(h, w)
    mult = 1 << levels
    base = img[_edge_index(h, 0, (-h) % mult, img.device)][
        :, _edge_index(w, 0, (-w) % mult, img.device)]
    down = [_bright_pass(base, threshold, knee)]
    for _ in range(levels):
        down.append(_blur5(down[-1])[::2, ::2])
    up = down[-1]
    for lvl in range(levels - 1, -1, -1):
        up = _blur5(_upsample2(up)) + down[lvl]
    return up[:h, :w] / float(levels + 1)


def apply_bloom(img, strength: float, threshold: float = 1.0,
                knee: float = 0.5):
    """``img + strength * glow`` in linear radiance; ``strength`` 0 returns
    ``img`` itself (no pyramid is built)."""
    if strength <= 0.0:
        return img
    return img + float(strength) * bloom_layer(
        img, threshold=float(threshold), knee=float(knee))
