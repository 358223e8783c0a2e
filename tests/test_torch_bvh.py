"""Port parity: the ``traversal="bvh"`` route (ROADMAP queue A item 20).
The same scenes and numpy rays, from fixed seeds, go through the JAX
package's threaded-BVH walk (``jax.vmap`` of ``ops.bvh.traverse``, as
``intersect_scene_batch`` runs it) and the port's batched plain-torch walk
on the CPU.

* ``traverse`` on a random soup (with rays that miss, rays from inside,
  and a finite cap): ``prim`` equals the JAX walk's on every ray, so the
  port visits the nodes and breaks ties as JAX does. ``t`` is not bit for
  bit: XLA:CPU compiles the walk into one loop and contracts its
  multiply-adds (``jnp.cross`` alone gives one fused multiply-add per
  component, even eagerly), while torch rounds every product. Measured
  over the 1,402 hits of 6,000 rays: 754 t differ, by at most 1.6e-6
  relative; the test allows 4e-6.
* The "bvh" branches of ``intersect_batch`` and ``occluded_batch`` agree
  with the JAX "bvh" route (spheres, triangles and misses equal; measured:
  t within 2.5e-6 relative, normals within 1.2e-7, as the fused cross
  product rounds them apart; the test allows 4e-6 and 2e-6), and both
  refuse an instanced scene.
* ``render_once`` with ``traversal="bvh"``: cornell_bsdf agrees with the
  JAX "bvh" render at 24x24, 3 spp (measured largest per-pixel difference
  8.2e-5). textured_demo, through the prim branch of
  ``surface_attributes``, agrees with the port's own cluster route within
  1e-4 (measured 5.9e-6) and with the JAX "cluster_jax" render within the
  tolerance of ``tests/test_torch_render.py`` (measured 1.0e-5). Against
  the JAX "bvh" render 5 of its 576 pixels differ by up to 0.056 (3 to 5
  at seeds 1 to 3): that route's
  triangle normal is ``normalize(jnp.cross(e1, e2))``, rounded by the
  fused multiply-adds, while the cluster routes of both packages read the
  numpy-built normal table; a port run with the fused cross emulated
  matched the JAX "bvh" render to 1.6e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.models import progressive as jprog
from pathtracing_tpu.models import scene as jscene_mod
from pathtracing_tpu.models import scenes as jscenes
from pathtracing_tpu.ops import bvh as jbvh
from pathtracing_tpu.ops import bvh_native
from pathtracing_tpu.ops.camera import build_camera as jcamera
from pathtracing_tpu.utils.config import RenderConfig as JConfig
from pathtracing_tpu_torch.models import progressive as tprog
from pathtracing_tpu_torch.models import scene as tscene_mod
from pathtracing_tpu_torch.models import scenes as tscenes
from pathtracing_tpu_torch.ops import bvh as tbvh
from pathtracing_tpu_torch.ops.camera import build_camera as tcamera
from pathtracing_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(2)


def _soup(builder_cls, n=900, seed=0):
    """Random triangles, a few spheres, two materials."""
    rs = np.random.RandomState(seed)
    b = builder_cls()
    m0 = b.lambertian((0.5, 0.5, 0.5))
    m1 = b.emissive((2.0, 2.0, 2.0))
    v0 = rs.uniform(-2.0, 2.0, (n, 3))
    for i in range(n):
        b.add_triangle(v0[i], v0[i] + rs.normal(0, 0.3, 3),
                       v0[i] + rs.normal(0, 0.3, 3), m1 if i % 7 == 0 else m0)
    for c in rs.uniform(-1.5, 1.5, (3, 3)):
        b.add_sphere(tuple(c), 0.3, m0)
    return b


@pytest.fixture(scope="module")
def soup():
    from pathtracing_tpu.models.scene import SceneBuilder as JBuilder

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bvh_native, "build", lambda *a, **k: None)
        return (_soup(JBuilder).build(),
                _soup(tscene_mod.SceneBuilder).build("cpu"))


def _rays(n, seed):
    rs = np.random.RandomState(seed)
    o = (rs.randn(n, 3) * 2.0).astype(np.float32)
    d = rs.randn(n, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("cap", ["inf", "finite"])
def test_traverse_matches_jax(soup, cap):
    sj, st = soup
    o, d = _rays(3000, 1)
    t_max = (np.full(3000, np.inf, np.float32) if cap == "inf" else
             np.random.RandomState(2).uniform(0.1, 3.0, 3000).astype(
                 np.float32))
    walk = jax.jit(jax.vmap(lambda oo, dd, tt: jbvh.traverse(
        sj.bvh, sj.tri_v0, sj.tri_e1, sj.tri_e2, oo, dd, tt)))
    tj, pj = (np.asarray(x) for x in walk(jnp.asarray(o), jnp.asarray(d),
                                          jnp.asarray(t_max)))
    tt, pt = tbvh.traverse(st.bvh, st.tri_v0, st.tri_e1, st.tri_e2,
                           torch.as_tensor(o), torch.as_tensor(d),
                           torch.as_tensor(t_max))
    assert pt.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), pj)
    hit = pj >= 0
    assert 300 < hit.sum() < 2900
    np.testing.assert_allclose(tt.numpy()[hit], tj[hit], rtol=4e-6)
    np.testing.assert_array_equal(tt.numpy()[~hit], tj[~hit])


def test_intersect_and_occluded_batch_match_jax(soup):
    sj, st = soup
    o, d = _rays(2000, 3)
    hj = jscene_mod.intersect_batch(sj, jnp.asarray(o), jnp.asarray(d), "bvh")
    ht = tscene_mod.intersect_batch(st, torch.as_tensor(o),
                                    torch.as_tensor(d), "bvh")
    for f in ("valid", "tri", "prim", "mat_id", "front"):
        np.testing.assert_array_equal(getattr(ht, f).numpy(),
                                      np.asarray(getattr(hj, f)), f)
    v = np.asarray(hj.valid)
    assert ht.slot is None and 0 < np.asarray(hj.tri).sum() < v.sum()
    np.testing.assert_allclose(ht.t.numpy()[v], np.asarray(hj.t)[v],
                               rtol=4e-6)
    np.testing.assert_allclose(ht.normal.numpy()[v],
                               np.asarray(hj.normal)[v], atol=2e-6)
    t_max = np.random.RandomState(4).uniform(0.05, 4.0, 2000).astype(
        np.float32)
    active = np.random.RandomState(5).rand(2000) > 0.2
    oj = jscene_mod.occluded_batch(sj, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(t_max), "bvh",
                                   active=jnp.asarray(active))
    ot = tscene_mod.occluded_batch(st, torch.as_tensor(o), torch.as_tensor(d),
                                   torch.as_tensor(t_max), "bvh",
                                   active=torch.as_tensor(active))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert 0 < int(ot.sum()) < int(active.sum())


def test_bvh_route_refuses_instanced_scenes():
    scene, _ = tscenes.instanced_demo(grid=2, subdivisions=0, device="cpu")
    o, d = (torch.as_tensor(x) for x in _rays(16, 6))
    with pytest.raises(ValueError, match="instanced"):
        tscene_mod.intersect_batch(scene, o, d, "bvh")
    with pytest.raises(ValueError, match="instanced"):
        tscene_mod.occluded_batch(scene, o, d, torch.ones(16), "bvh")


def _render(name, traversal_j, traversal_t):
    kw = dict(width=24, height=24, samples_per_pixel=3, max_depth=4, seed=1,
              nee=True, background=jscenes.preferred_background(name))
    sj, cc = jscenes.SCENES[name]()
    st, _ = tscenes.get_scene(name, device="cpu")
    img_t = tprog.render_once(st, tcamera(cc, 1.0, device="cpu"),
                              TConfig(traversal=traversal_t, **kw)).numpy()
    if traversal_j is None:
        return tprog.render_once(st, tcamera(cc, 1.0, device="cpu"),
                                 TConfig(**kw)).numpy(), img_t
    return np.asarray(jprog.render_once(
        sj, jcamera(cc, 1.0), JConfig(traversal=traversal_j, **kw))), img_t


@pytest.mark.parametrize("name,jax_route", [
    ("cornell_bsdf", "bvh"), ("textured_demo", "cluster_jax"),
    ("textured_demo", None)])
def test_bvh_render_matches(name, jax_route):
    """``jax_route`` None: against the port's own cluster route."""
    ref, img = _render(name, jax_route, "bvh")
    assert np.isfinite(img).all() and img.mean() > 0.05
    diff = np.abs(ref - img).max(axis=-1)
    if jax_route is None:
        assert diff.max() <= 1e-4
        return
    assert (diff > 1e-3).mean() <= 0.01
    assert abs(img.mean() - ref.mean()) <= 0.01 * ref.mean()
