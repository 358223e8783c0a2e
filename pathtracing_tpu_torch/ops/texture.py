"""Image textures (the JAX package's ``ops/texture.py``): one padded atlas
and bilinear / trilinear UV lookups.

Every texture of a scene lives in ONE padded (N, H, W, 3) float32 tensor,
so a lookup is a gather by (texture id, row, column) with no per-texture
branch. ``build_atlas`` runs on the host in numpy and gives the JAX
package's layout bit for bit, with or without the mip column.

Conventions (as in the JAX package):
  * UV origin is bottom-left; image row 0 is the top, so v is flipped.
  * Wrap mode is repeat on both axes. The texel index wraps by a floor
    modulo (``torch.remainder``, as ``jnp.mod``): a lookup with u below
    half a texel reads column -1, which wraps to the last column.
  * Texels are linear; the sampled color MODULATES a material's albedo.

Image files load on the host (``load_texture``: PNG/JPEG through Pillow,
converted from sRGB; ``.hdr`` and ``.npy`` linear).
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from pathtracing_tpu_torch.ops import envmap


class TextureAtlas(NamedTuple):
    """Every texture of a scene.

    texels: (N, H, Wp, 3) f32, padded to the largest texture (padding is
            0 and never sampled). With mips, level 0 sits at [:, :h, :w]
            and levels >= 1 stack top-down in a right-hand column (x >= W).
    size:   (N, 2) i32 (height, width) of level 0 of each texture.
    mip_table: (N, L, 4) i32 (y0, x0, h, w) per (texture, level), or None
            for a bilinear-only atlas. Short pyramids repeat their 1x1
            tail row, so every clamped LOD is valid for every texture.

    ``build_atlas`` returns numpy arrays; ``to_device`` uploads them."""

    texels: object
    size: object
    mip_table: object = None


def _downsample2(im: np.ndarray) -> np.ndarray:
    """One box-filtered mip halving (host side); odd trailing rows and
    columns are dropped."""
    h, w = im.shape[:2]
    nh, nw = max(1, h // 2), max(1, w // 2)
    a = im[0:2 * nh:2, 0:2 * nw:2]
    b = im[1:2 * nh:2, 0:2 * nw:2] if h > 1 else a
    c = im[0:2 * nh:2, 1:2 * nw:2] if w > 1 else a
    d = (im[1:2 * nh:2, 1:2 * nw:2] if (h > 1 and w > 1)
         else (b if h > 1 else c))
    return ((a + b + c + d) * 0.25).astype(np.float32)


def build_atlas(images: Sequence[np.ndarray],
                mips: bool = False) -> TextureAtlas:
    """Pack host images ((H, W, 3) float arrays of any sizes) into one
    padded atlas of numpy arrays. With ``mips`` each texture also gets a
    box-filtered pyramid down to 1x1 in a right-hand column and the atlas
    carries a ``mip_table``; without it the layout is the mip-free one."""
    if not images:
        raise ValueError("build_atlas needs at least one image")
    imgs: List[np.ndarray] = []
    for im in images:
        a = np.asarray(im, np.float32)
        if a.ndim == 2:
            a = np.repeat(a[:, :, None], 3, axis=2)
        if a.ndim != 3 or a.shape[2] < 3:
            raise ValueError(f"texture must be (H, W, 3); got {a.shape}")
        imgs.append(np.ascontiguousarray(a[:, :, :3]))
    h = max(im.shape[0] for im in imgs)
    w = max(im.shape[1] for im in imgs)
    size = np.array([im.shape[:2] for im in imgs], np.int32)
    if not mips:
        texels = np.zeros((len(imgs), h, w, 3), np.float32)
        for i, im in enumerate(imgs):
            texels[i, :im.shape[0], :im.shape[1]] = im
        return TextureAtlas(texels=texels, size=size)

    pyramids = []
    for im in imgs:
        levels = [im]
        while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
            levels.append(_downsample2(levels[-1]))
        pyramids.append(levels)
    n_levels = max(len(p) for p in pyramids)
    pad_w = max(max(1, im.shape[1] // 2) for im in imgs)
    texels = np.zeros((len(imgs), h, w + pad_w, 3), np.float32)
    table = np.zeros((len(imgs), n_levels, 4), np.int32)
    for i, levels in enumerate(pyramids):
        texels[i, :levels[0].shape[0], :levels[0].shape[1]] = levels[0]
        table[i, 0] = (0, 0, levels[0].shape[0], levels[0].shape[1])
        y = 0
        for li, lv in enumerate(levels[1:], start=1):
            texels[i, y:y + lv.shape[0], w:w + lv.shape[1]] = lv
            table[i, li] = (y, w, lv.shape[0], lv.shape[1])
            y += lv.shape[0]
        for li in range(len(levels), n_levels):
            table[i, li] = table[i, len(levels) - 1]
    return TextureAtlas(texels=texels, size=size, mip_table=table)


def to_device(atlas: TextureAtlas, device) -> TextureAtlas:
    """The atlas's arrays as tensors on ``device`` (texels f32, the size
    and mip tables i32)."""
    def dev(x, dtype):
        return None if x is None else torch.tensor(
            np.asarray(x), dtype=dtype, device=device)
    return TextureAtlas(texels=dev(atlas.texels, torch.float32),
                        size=dev(atlas.size, torch.int32),
                        mip_table=dev(atlas.mip_table, torch.int32))


def add_mips(atlas: TextureAtlas) -> TextureAtlas:
    """A bilinear-only atlas (tensors) rebuilt with a mip pyramid, on the
    same device: the retrofit the JAX CLI applies for ``--mips``. The
    padded atlas holds each source exactly at [:h, :w], so cropping
    recovers every image bit for bit. Host side, once per scene."""
    if atlas.mip_table is not None:
        return atlas
    tex = atlas.texels.cpu().numpy()
    size = atlas.size.cpu().numpy()
    imgs = [tex[i, :size[i, 0], :size[i, 1]] for i in range(tex.shape[0])]
    return to_device(build_atlas(imgs, mips=True), atlas.texels.device)


def _bilinear(atlas: TextureAtlas, tid, uv, y_off, x_off, th, tw):
    """The bilinear texel math of both lookups: repeat wrap, v flipped,
    texel centers at half-integers. ``th``/``tw`` are the level's float
    sizes, ``y_off``/``x_off`` its placement (None at level 0 of
    ``sample_bilinear``)."""
    u = uv[:, 0] - torch.floor(uv[:, 0])
    v = uv[:, 1] - torch.floor(uv[:, 1])
    x = u * tw - 0.5
    y = (1.0 - v) * th - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    hi = torch.clamp(th, min=1.0).to(torch.int32)
    wi = torch.clamp(tw, min=1.0).to(torch.int32)
    tl = tid.long()

    def texel(yi, xi):
        yw = torch.remainder(yi.to(torch.int32), hi)
        xw = torch.remainder(xi.to(torch.int32), wi)
        if y_off is not None:
            yw = y_off + yw
            xw = x_off + xw
        return atlas.texels[tl, yw.long(), xw.long()]

    c00 = texel(y0, x0)
    c01 = texel(y0, x0 + 1.0)
    c10 = texel(y0 + 1.0, x0)
    c11 = texel(y0 + 1.0, x0 + 1.0)
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def sample_bilinear(atlas: TextureAtlas, tex_id, uv):
    """Bilinear lookup: ``tex_id`` (R,) i32 (clamped in range; callers mask
    rows with a negative id), ``uv`` (R, 2) f32. Returns (R, 3) linear
    color."""
    tid = torch.clamp(tex_id, 0, atlas.texels.shape[0] - 1).long()
    th = atlas.size[tid, 0].to(torch.float32)
    tw = atlas.size[tid, 1].to(torch.float32)
    return _bilinear(atlas, tid, uv, None, None, th, tw)


def _sample_level(atlas: TextureAtlas, tid, uv, level):
    """Bilinear lookup at a per-ray mip level (``tid`` clamped, ``level``
    (R,) i32 in [0, L)): the level's placement row from ``mip_table``,
    then ``sample_bilinear``'s math (level 0 rows are (0, 0, h, w), so it
    equals ``sample_bilinear`` bit for bit at LOD 0)."""
    row = atlas.mip_table[tid.long(), level.long()]
    return _bilinear(atlas, tid, uv, row[:, 0], row[:, 1],
                     row[:, 2].to(torch.float32), row[:, 3].to(torch.float32))


def sample_trilinear(atlas: TextureAtlas, tex_id, uv, lod_base):
    """Trilinear (mip-interpolated) lookup. ``lod_base`` (R,) f32 is log2
    of the ray's footprint in UV units; the texture's own resolution term
    0.5·log2(h·w) is added here. An atlas without mips falls back to
    ``sample_bilinear``."""
    if atlas.mip_table is None:
        return sample_bilinear(atlas, tex_id, uv)
    n_levels = atlas.mip_table.shape[1]
    tid = torch.clamp(tex_id, 0, atlas.texels.shape[0] - 1).long()
    th = atlas.size[tid, 0].to(torch.float32)
    tw = atlas.size[tid, 1].to(torch.float32)
    lod = lod_base + 0.5 * torch.log2(torch.clamp(th * tw, min=1.0))
    lod = torch.clamp(lod, 0.0, float(n_levels - 1))
    l0 = torch.floor(lod)
    f = (lod - l0)[:, None]
    l0i = l0.to(torch.int32)
    l1i = torch.clamp(l0i + 1, max=n_levels - 1)
    c0 = _sample_level(atlas, tid, uv, l0i)
    c1 = _sample_level(atlas, tid, uv, l1i)
    return c0 * (1.0 - f) + c1 * f


def srgb_to_linear(img: np.ndarray) -> np.ndarray:
    """Exact sRGB EOTF (host side, for 8-bit image data)."""
    img = np.asarray(img, np.float32)
    lo = img / 12.92
    hi = np.power((img + 0.055) / 1.055, 2.4, dtype=np.float32)
    return np.where(img <= 0.04045, lo, hi).astype(np.float32)


def load_texture(path: str, srgb: bool = True) -> np.ndarray:
    """An image file as a linear (H, W, 3) f32 texture: ``.hdr`` (Radiance
    RGBE) and ``.npy`` are linear already; 8-bit formats (PNG, JPEG, via
    Pillow) convert from sRGB unless ``srgb=False`` (normal maps hold
    direction data, not colour)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        return envmap.load_hdr(path)
    if ext == ".npy":
        return np.asarray(np.load(path), np.float32)
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
    return srgb_to_linear(arr) if srgb else arr
