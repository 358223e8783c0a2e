"""Port parity: delta lights (``ops/lights.py``: ``DeltaLights``,
``build_delta_lights``, ``sample_delta``) and ``SceneBuilder``'s
``point_light``, ``spot_light`` and ``directional_light``.

The tables are byte-equal (host numpy in both packages). ``sample_delta``
picks the same light (the count Σ(u > cum), exact) and returns the same
shadow distance and radiance to rtol 1e-5 / atol 1e-6 and directions to
atol 1e-6 (measured on these inputs: directions within 1.2e-7, shadow
distances within 1.2e-7 relative, radiance equal; the JAX pick is a
masked one-hot sum, the port's an index, both exact copies).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.models.scene import SceneBuilder as JBuilder
from pathtracing_tpu.ops import lights as jlights
from pathtracing_tpu_torch.models.scene import SceneBuilder as TBuilder
from pathtracing_tpu_torch.ops import lights as tlights

torch.set_num_threads(2)

SPECS = [
    {"type": "spot", "position": (-0.7, 3.5, 0.3),
     "direction": (0.0, -1.0, -0.08), "intensity": (55.0, 50.0, 42.0),
     "inner_degrees": 12.0, "outer_degrees": 22.0},
    {"type": "point", "position": (3.0, 1.5, 2.5),
     "intensity": (2.5, 3.5, 6.0)},
    {"type": "directional", "direction": (-0.4, -1.0, -0.3),
     "irradiance": (0.25, 0.25, 0.3)},
    {"type": "spot", "position": (1.0, 2.0, -1.0),
     "direction": (0.3, -1.0, 0.2), "intensity": (9.0, 3.0, 1.0),
     "inner_degrees": 25.0, "outer_degrees": 25.0},
]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tables_equal(dj, dt):
    for f in tlights.DeltaLights._fields:
        a, b = _np(getattr(dj, f)), _np(getattr(dt, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f


@pytest.fixture(scope="module")
def tables():
    return (jlights.build_delta_lights(SPECS),
            tlights.build_delta_lights(SPECS, "cpu"))


def test_tables_byte_equal(tables):
    _assert_tables_equal(*tables)
    assert tables[1].kind.tolist() == [0, 0, 1, 0]


def test_no_lights_or_no_power_gives_none():
    assert tlights.build_delta_lights([], "cpu") is None
    dark = [{"type": "point", "position": (0, 1, 0),
             "intensity": (0.0, 0.0, 0.0)}]
    assert tlights.build_delta_lights(dark, "cpu") is None
    assert jlights.build_delta_lights(dark) is None
    with pytest.raises(ValueError):
        tlights.build_delta_lights([{"type": "area", "position": (0, 1, 0),
                                     "intensity": (1.0, 1.0, 1.0)}], "cpu")


def test_builder_methods_match_jax():
    builders = (JBuilder(), TBuilder())
    for b in builders:
        m = b.lambertian((0.5, 0.5, 0.5))
        b.add_quad((-1, 0, -1), (2, 0, 0), (0, 0, 2), m)
        b.spot_light((-0.7, 3.5, 0.3), (0.0, -1.0, -0.08),
                     (55.0, 50.0, 42.0), inner_degrees=12.0,
                     outer_degrees=22.0)
        b.point_light((3.0, 1.5, 2.5), (2.5, 3.5, 6.0))
        b.directional_light((-0.4, -1.0, -0.3), (0.25, 0.25, 0.3))
    sj, st = builders[0].build(), builders[1].build("cpu")
    _assert_tables_equal(sj.delta, st.delta)
    assert float(st.lights.total_power) == 0.0


def test_sample_delta_matches(tables):
    dj, dt = tables
    rs = np.random.RandomState(6)
    n = 6000
    u = rs.rand(n).astype(np.float32)
    u[:4] = np.asarray(dj.cum)            # exactly on the CDF
    origin = (rs.rand(n, 3) * np.array([6.0, 2.0, 6.0])
              - np.array([3.0, 0.0, 3.0])).astype(np.float32)
    origin[4] = (3.0, 1.5, 2.5)          # on the point light itself
    wj, tj, lj = (np.asarray(x) for x in jlights.sample_delta(
        dj, jnp.asarray(u), jnp.asarray(origin)))
    wt, tt, lt = (x.numpy() for x in tlights.sample_delta(
        dt, torch.as_tensor(u), torch.as_tensor(origin)))
    np.testing.assert_allclose(wj, wt, atol=1e-6)
    np.testing.assert_allclose(tj, tt, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lj, lt, rtol=1e-5, atol=1e-6)
    assert np.isfinite(lt).all()
    assert (tt == 1.0e7).any() and (tt < 1.0e7).any()
    # The spot's smoothstep leaves some receivers dark, some lit.
    assert (lt.max(axis=1) == 0.0).any() and (lt.max(axis=1) > 0.0).any()
