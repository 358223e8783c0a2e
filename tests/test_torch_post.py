"""Port parity: the post-passes, ``models/aov.py``, ``ops/denoise.py`` and
``ops/bloom.py``, against the JAX package on the CPU.

  * AOVs: all five kinds on cornell_bsdf (mirror, glass, a light) and uv
    and albedo on textured_demo, 16x16: finite, in [0, 1], and within
    1e-5 of JAX's on all but 3% of the pixels (measured: largest
    difference elsewhere 8.5e-6, textured albedo; at most 2 of 256 pixels
    beyond, first-sample rays through a box edge, where XLA:CPU's fused
    multiply-adds pick the other triangle, ROADMAP caveat C8).
  * ``guidance_buffers`` (pixel-centre rays, the shutter midpoint): the
    same edge fraction (measured 5 of 256 pixels), 2e-5 elsewhere
    (measured 1.3e-5, a sphere's normal follows its hit point).
  * ``denoise`` on the same numpy inputs (random radiance with fireflies,
    normals, albedo with black texels, depths, a validity mask with
    holes; 13x17 and 24x24, with and without spp, demodulation and the
    firefly clamp): within 2e-6 relative to the image's peak (measured
    5.2e-8; XLA's and torch's exp differ by an ulp on some inputs).
    ``denoise_render`` is ``denoise`` of ``guidance_buffers``.
  * Bloom: the 2x upsample against ``jax.image.resize(method="linear")``
    at odd and even sizes within 1e-6 relative (a last-bit difference on
    up to a third of the texels: XLA contracts each axis with a weight
    matrix); ``apply_bloom`` within 2e-6 relative to the peak (measured
    6.4e-8); ``num_levels`` equal; strength 0 returns the image itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.models import aov as jaov
from pathtracing_tpu.models import scenes as jscenes
from pathtracing_tpu.ops import bloom as jbloom
from pathtracing_tpu.ops import bvh_native
from pathtracing_tpu.ops import denoise as jdenoise
from pathtracing_tpu.ops.camera import build_camera as jcamera
from pathtracing_tpu.utils.config import RenderConfig as JConfig
from pathtracing_tpu_torch.models import aov as taov
from pathtracing_tpu_torch.models import scenes as tscenes
from pathtracing_tpu_torch.ops import bloom as tbloom
from pathtracing_tpu_torch.ops import denoise as tdenoise
from pathtracing_tpu_torch.ops.camera import build_camera as tcamera
from pathtracing_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(2)

SIZE = 16
KW = dict(width=SIZE, height=SIZE, samples_per_pixel=4, max_depth=2,
          seed=3)
# The share of pixels whose ray passes through an edge of the scene (see
# the module docstring), and the tolerance elsewhere.
EDGE_FRACTION = 0.03
ATOL = 1e-5


@pytest.fixture(scope="module")
def scenes():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bvh_native, "build", lambda *a, **k: None)
        for name in ("cornell_bsdf", "textured_demo"):
            sj, cc = jscenes.get_scene(name)
            st, _ = tscenes.get_scene(name, device="cpu")
            bg = jscenes.preferred_background(name)
            out[name] = (sj, jcamera(cc, 1.0), st,
                         tcamera(cc, 1.0, device="cpu"), bg)
    return out


def _close_but_edges(a, b, atol=ATOL):
    """(H, W, 3) images within ``atol`` on all but EDGE_FRACTION of the
    pixels."""
    diff = np.abs(np.asarray(a) - np.asarray(b)).max(axis=-1)
    assert (diff > atol).mean() <= EDGE_FRACTION, diff.max()
    return diff


@pytest.mark.parametrize("scene,kind", [
    *(("cornell_bsdf", k) for k in taov.AOV_KINDS),
    ("textured_demo", "uv"), ("textured_demo", "albedo"),
])
def test_aov_matches_jax(scenes, scene, kind):
    sj, cj, st, ct, bg = scenes[scene]
    cfg_t = TConfig(background=bg, **KW)
    cfg_j = JConfig(background=bg, traversal="cluster_jax", **KW)
    img_t = taov.render_aov(st, ct, cfg_t, kind).numpy()
    img_j = np.asarray(jaov.render_aov(sj, cj, cfg_j, kind))
    assert img_t.shape == (SIZE, SIZE, 3) and np.isfinite(img_t).all()
    assert img_t.min() >= 0.0 and img_t.max() <= 1.0
    if kind == "uv":
        assert img_t[..., :2].max() > 0.0 or scene == "cornell_bsdf"
    _close_but_edges(img_t, img_j)


def test_unknown_aov_kind_raises(scenes):
    _, _, st, ct, _ = scenes["cornell_bsdf"]
    with pytest.raises(ValueError, match="unknown AOV"):
        taov.render_aov(st, ct, TConfig(**KW), "roughness")


def test_guidance_buffers_match_jax(scenes):
    sj, cj, st, ct, bg = scenes["cornell_bsdf"]
    cfg_t = TConfig(background=bg, **KW)
    gj = [np.asarray(a) for a in jdenoise.guidance_buffers(
        sj, cj, JConfig(background=bg, traversal="cluster_jax", **KW))]
    gt = [a.numpy() for a in tdenoise.guidance_buffers(st, ct, cfg_t)]
    bad = np.zeros((SIZE, SIZE), bool)
    for a, b in zip(gj, gt):
        assert a.shape == b.shape and a.dtype == b.dtype
        d = np.abs(a - b)
        bad |= (d.max(-1) if d.ndim == 3 else d) > 2e-5
    assert bad.mean() <= EDGE_FRACTION
    assert gt[3].mean() > 0.9
    # denoise_render is denoise of these buffers.
    img = torch.as_tensor(np.random.RandomState(0).rand(SIZE, SIZE, 3)
                          .astype(np.float32))
    want = tdenoise.denoise(img, *(torch.as_tensor(g) for g in gt), spp=4)
    assert torch.equal(tdenoise.denoise_render(st, ct, cfg_t, img), want)


def _denoise_inputs(h, w, seed):
    rs = np.random.RandomState(seed)
    img = (rs.rand(h, w, 3) * 2).astype(np.float32)
    img[rs.rand(h, w) > 0.97] *= 40.0                    # fireflies
    n = rs.randn(h, w, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    albedo = rs.rand(h, w, 3).astype(np.float32)
    albedo[rs.rand(h, w) > 0.9] = 0.0                    # emitter-like
    depth = (rs.rand(h, w) * 3 + 0.5).astype(np.float32)
    valid = (rs.rand(h, w) > 0.15).astype(np.float32)
    return img, n, albedo, depth, valid


# Each case compiles the JAX filter anew (about 5 s), so the cases vary
# shape, spp, demodulation, clamp and iterations together.
@pytest.mark.parametrize("shape,kw", [
    ((13, 17), dict(spp=4)),
    ((24, 24), dict()),
    ((13, 17), dict(spp=2, demodulate=False, iterations=3,
                    sigma_color=0.8, firefly_clamp=0.0)),
])
def test_denoise_matches_jax(shape, kw):
    inputs = _denoise_inputs(*shape, seed=shape[0])
    want = np.asarray(jdenoise.denoise(*map(jnp.asarray, inputs), **kw))
    got = tdenoise.denoise(*map(torch.as_tensor, inputs), **kw).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("shape", [(8, 8), (9, 14), (17, 23), (31, 5)])
def test_upsample2_matches_jax_resize(shape):
    img = (np.random.RandomState(shape[1]).rand(*shape, 3) * 3).astype(
        np.float32)
    want = np.asarray(jax.image.resize(
        jnp.asarray(img), (2 * shape[0], 2 * shape[1], 3), method="linear"))
    got = tbloom._upsample2(torch.as_tensor(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(16, 16), (17, 23), (40, 9), (64, 48)])
@pytest.mark.parametrize("kw", [dict(), dict(threshold=0.5, knee=0.0)])
def test_bloom_matches_jax(shape, kw):
    rs = np.random.RandomState(shape[0])
    img = (rs.rand(*shape, 3) * 1.2).astype(np.float32)
    img[rs.rand(*shape) > 0.95] = 12.0                   # hot spots
    want = np.asarray(jbloom.apply_bloom(jnp.asarray(img), 0.6, **kw))
    got = tbloom.apply_bloom(torch.as_tensor(img), 0.6, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())
    assert tbloom.num_levels(*shape) == jbloom.num_levels(*shape)


def test_zero_strength_bloom_is_the_image():
    img = torch.rand(5, 7, 3)
    assert tbloom.apply_bloom(img, 0.0) is img
    assert all(tbloom.num_levels(h, w) == jbloom.num_levels(h, w)
               for h in (1, 15, 16, 31, 32, 1080, 4096)
               for w in (1, 16, 1920))
