"""Port parity: the environment map (``ops/envmap.py``).

* ``sky_texels`` and the ``build_envmap`` tables (CDFs, pdfs, the
  selection map, the black-map flag) are byte-equal to the JAX package's,
  for the sun-sky, a black map and a map with all-zero rows.
* The CDF inversion: the port searches (``torch.searchsorted``, and for a
  row's conditional CDF one float64 search over the rows laid end to
  end) where JAX counts ``sum(cdf < u)``; the indices are equal on CDFs
  with flat runs and with ``u`` exactly on a CDF value.
* ``radiance`` is an exact copy of the same texel. ``pdf`` and
  ``sample`` agree to rtol 2e-5 / atol 1e-6 (measured: directions within
  1.2e-7, pdfs within 2.5e-7 relative: torch's sin/cos/arccos/arctan2
  against XLA's, an ulp or two); the sampled texel rows agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.ops import envmap as jenv
from pathtracing_tpu_torch.ops import envmap as tenv

torch.set_num_threads(2)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _maps():
    rs = np.random.RandomState(3)
    zero_rows = rs.rand(16, 32, 3).astype(np.float32)
    zero_rows[[0, 5, 6, 15]] = 0.0
    zero_rows[8, 3:20] = 0.0            # a flat run inside a row's CDF
    return {
        "sky": jenv.sky_texels(sun_direction=(0.45, 0.55, -0.55),
                               sky_scale=0.35),
        "black": np.zeros((8, 16, 3), np.float32),
        "zero_rows": zero_rows,
    }


MAPS = _maps()


@pytest.fixture(scope="module", params=sorted(MAPS))
def envs(request):
    tx = MAPS[request.param]
    return request.param, jenv.build_envmap(tx), tenv.build_envmap(tx, "cpu")


def test_sky_texels_equal():
    for kw in ({}, dict(sun_direction=(0.4, 0.6, 0.5), sky_scale=0.35),
               dict(width=64, height=32, sun_angular_radius=0.05)):
        a, b = jenv.sky_texels(**kw), tenv.sky_texels(**kw)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_tables_byte_equal(envs):
    _, ej, et = envs
    for f in tenv.EnvMap._fields:
        a, b = _np(getattr(ej, f)), _np(getattr(et, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f


def _uniforms(cdf_values, n, seed):
    """Random uniforms plus every CDF value itself, its neighbours and
    the ends of [0, 1)."""
    rs = np.random.RandomState(seed)
    u = rs.rand(n).astype(np.float32)
    vals = np.unique(np.asarray(cdf_values, np.float32).ravel())
    extra = np.concatenate([
        vals, np.nextafter(vals, np.float32(0)),
        np.nextafter(vals, np.float32(2)),
        np.array([0.0, np.nextafter(np.float32(1), np.float32(0))],
                 np.float32)])
    extra = extra[(extra >= 0.0) & (extra < 1.0)]
    return np.concatenate([u, extra]).astype(np.float32)


def test_search_equals_the_jax_count(envs):
    name, ej, et = envs
    marg = np.asarray(ej.marg_cdf)
    cond = np.asarray(ej.cond_cdf)
    eh, ew = cond.shape
    u1 = _uniforms(marg, 3000, 1)
    count = np.minimum((marg[None, :] < u1[:, None]).sum(1), eh - 1)
    iy = torch.clamp(tenv.cdf_index(et.marg_cdf, torch.as_tensor(u1)),
                     max=eh - 1)
    np.testing.assert_array_equal(count, iy.numpy())
    # Row searches: every row against every uniform (its own CDF values
    # included), so flat runs and exact hits are met.
    u2 = _uniforms(cond, 400, 2)
    rows = np.repeat(np.arange(eh), u2.shape[0])
    uu = np.tile(u2, eh)
    count = np.minimum((cond[rows] < uu[:, None]).sum(1), ew - 1)
    ix = torch.clamp(tenv._row_index(et, torch.as_tensor(rows),
                                     torch.as_tensor(uu)), max=ew - 1)
    np.testing.assert_array_equal(count, ix.numpy())
    if name == "zero_rows":
        flat = cond[8]
        assert (np.diff(flat) == 0).any()


def _directions(n, seed):
    rs = np.random.RandomState(seed)
    d = rs.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:4] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [0, 0, -1]]
    return d.astype(np.float32)


def test_radiance_and_pdf_match(envs):
    _, ej, et = envs
    d = _directions(5000, 4)
    np.testing.assert_array_equal(
        np.asarray(jenv.radiance(ej, jnp.asarray(d))),
        tenv.radiance(et, torch.as_tensor(d)).numpy())
    np.testing.assert_allclose(np.asarray(jenv.pdf(ej, jnp.asarray(d))),
                               tenv.pdf(et, torch.as_tensor(d)).numpy(),
                               rtol=2e-5, atol=1e-6)


def test_sample_matches(envs):
    name, ej, et = envs
    rs = np.random.RandomState(5)
    u1, u2 = (rs.rand(8000).astype(np.float32) for _ in range(2))
    u1[:3] = (0.0, np.float32(ej.marg_cdf[3]), 0.5)
    dj, pj = jenv.sample(ej, jnp.asarray(u1), jnp.asarray(u2))
    dt, pt = tenv.sample(et, torch.as_tensor(u1), torch.as_tensor(u2))
    dj, pj = np.asarray(dj), np.asarray(pj)
    np.testing.assert_allclose(dj, dt.numpy(), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(pj, pt.numpy(), rtol=2e-5, atol=1e-6)
    # u1 = 0 picks row 0, which has no weight in the zero-rows map: its
    # pdf is 0 in both packages.
    assert np.isfinite(pt.numpy()).all() and (pt.numpy() >= 0).all()
    if name == "sky":
        assert (pt.numpy() > 0).all()
    # Sampled directions land where their pdf says (same table row).
    ij = jenv._texel_index(ej, jnp.asarray(dj))
    it = tenv._texel_index(et, dt)
    agree = np.asarray(ij[0]) == it[0].numpy()
    assert agree.mean() > 0.999
    if name == "black":
        np.testing.assert_allclose(pt.numpy(), 1.0 / (4.0 * np.pi),
                                   rtol=1e-6)
