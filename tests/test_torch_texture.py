"""Port parity: ``ops/texture.py``. The same numpy images and uvs, from a
fixed seed, go through the JAX package's functions (eagerly, on the CPU)
and the port's.

* ``build_atlas`` gives the JAX layout bit for bit, with and without the
  mip column, for uneven sizes (odd, 1-texel-wide, 1x1); ``add_mips``
  recovers the sources and equals a mip build of them.
* ``sample_bilinear`` equals the JAX lookup bit for bit with u and v in
  [-2, 3] (the texel wrap is a floor modulo, as ``jnp.mod``: u just
  below half a texel reads the last column), for every texture id of the
  atlas and clamped ids outside it. ``sample_trilinear`` adds the
  texture's resolution term 0.5·log2(h·w), and XLA's and torch's log2
  differ by one ulp for some sizes (log2(144): 7.1699247 against
  7.169925): measured over 4,099 lookups, 168 differ, by at most
  1.19e-7 (one ulp of a texel value below 1); the test allows 2.4e-7.
* Trilinear at LOD 0 equals bilinear bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.ops import texture as jtex
from pathtracing_tpu_torch.ops import texture as ttex

torch.set_num_threads(2)

SIZES = [(5, 7), (8, 3), (1, 1), (16, 9), (2, 1)]


def _images(seed=0):
    rs = np.random.RandomState(seed)
    return [rs.rand(h, w, 3).astype(np.float32) for h, w in SIZES]


def _bytes_equal(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and (
        a.tobytes() == b.tobytes())


def _atlases(mips):
    imgs = _images()
    ja = jtex.build_atlas(imgs, mips=mips)
    ta = ttex.to_device(ttex.build_atlas(imgs, mips=mips), "cpu")
    return ja, ta


def _uv_ids(n, n_tex, seed=1):
    rs = np.random.RandomState(seed)
    uv = rs.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)
    ids = rs.randint(-1, n_tex + 1, n).astype(np.int32)
    return uv, ids


@pytest.mark.parametrize("mips", [False, True])
def test_build_atlas_matches_jax(mips):
    ja, ta = _atlases(mips)
    assert _bytes_equal(ja.texels, ta.texels)
    assert _bytes_equal(ja.size, ta.size)
    if mips:
        assert _bytes_equal(ja.mip_table, ta.mip_table)
        assert ja.mip_table.shape[1] == 5     # 16x9 down to 1x1
    else:
        assert ta.mip_table is None and ja.mip_table is None


def test_downsample_and_srgb_match_jax():
    for im in _images(3):
        assert _bytes_equal(jtex._downsample2(im), ttex._downsample2(im))
    x = np.linspace(0.0, 1.2, 997, dtype=np.float32).reshape(-1, 1)
    assert _bytes_equal(jtex.srgb_to_linear(x), ttex.srgb_to_linear(x))


def test_add_mips_recovers_the_sources():
    imgs = _images()
    plain = ttex.to_device(ttex.build_atlas(imgs), "cpu")
    mipped = ttex.add_mips(plain)
    ref = ttex.build_atlas(imgs, mips=True)
    for a, b in zip(ref, mipped):
        assert _bytes_equal(a, b)
    for i, im in enumerate(imgs):
        h, w = im.shape[:2]
        assert _bytes_equal(im, mipped.texels[i, :h, :w])
    assert ttex.add_mips(mipped) is mipped
    ja = jtex.add_mips(jtex.build_atlas(imgs))
    for a, b in zip(ja, mipped):
        assert _bytes_equal(a, b)


@pytest.mark.parametrize("mips", [False, True])
def test_sample_bilinear_matches_jax(mips):
    ja, ta = _atlases(mips)
    uv, ids = _uv_ids(4099, len(SIZES))
    a = jtex.sample_bilinear(ja, jnp.asarray(ids), jnp.asarray(uv))
    b = ttex.sample_bilinear(ta, torch.as_tensor(ids), torch.as_tensor(uv))
    assert _bytes_equal(a, b)


def test_sample_trilinear_matches_jax():
    ja, ta = _atlases(True)
    uv, ids = _uv_ids(4099, len(SIZES), seed=2)
    lod = np.random.RandomState(4).uniform(-9.0, 2.0, 4099).astype(
        np.float32)
    a = np.asarray(jtex.sample_trilinear(ja, jnp.asarray(ids),
                                         jnp.asarray(uv), jnp.asarray(lod)))
    b = ttex.sample_trilinear(ta, torch.as_tensor(ids), torch.as_tensor(uv),
                              torch.as_tensor(lod)).numpy()
    assert np.abs(a - b).max() <= 2.4e-7
    assert (a == b).all(axis=1).mean() > 0.9
    # Without mips the lookup is plain bilinear.
    jb, tb = _atlases(False)
    assert _bytes_equal(
        ttex.sample_trilinear(tb, torch.as_tensor(ids), torch.as_tensor(uv),
                              torch.as_tensor(lod)),
        ttex.sample_bilinear(tb, torch.as_tensor(ids), torch.as_tensor(uv)))


def test_trilinear_at_lod_zero_is_bilinear():
    _, ta = _atlases(True)
    uv, ids = _uv_ids(2000, len(SIZES), seed=5)
    uv, ids = torch.as_tensor(uv), torch.as_tensor(ids)
    # A footprint far below one texel clamps every texture to level 0.
    lod = torch.full((2000,), -40.0)
    assert _bytes_equal(ttex.sample_trilinear(ta, ids, uv, lod).numpy(),
                        ttex.sample_bilinear(ta, ids, uv))


def test_texel_wrap_is_a_floor_modulo():
    """u just below half a texel reads column -1 and column 0: the floor
    modulo wraps -1 to the last column (a truncating fmod would index out
    of the texture)."""
    img = np.zeros((1, 4, 3), np.float32)
    img[0, 3] = 1.0                   # the last column is white
    atlas = ttex.to_device(ttex.build_atlas([img]), "cpu")
    uv = torch.tensor([[0.01, 0.5], [-1.99, 0.5], [2.01, 0.5]])
    out = ttex.sample_bilinear(atlas, torch.zeros(3, dtype=torch.int32), uv)
    ref = jtex.sample_bilinear(jtex.build_atlas([img]), jnp.zeros(3, jnp.int32),
                               jnp.asarray(uv.numpy()))
    assert _bytes_equal(ref, out)
    # x = 0.01·4 − 0.5 = −0.46: 46% of the last column.
    assert torch.allclose(out[:, 0], torch.full((3,), 0.46), atol=1e-5)
