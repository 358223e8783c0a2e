"""Port parity for many-light scenes: the packed light table and the
gather-mode pick, emissive spheres, the principled lobe and the whole
``many_lights_demo`` render, fed the same numpy inputs in both packages.

Tolerances and why:
  * light tables (packed rows included), pick indices and gathered rows:
    exact (integer outputs and copies);
  * gather mode against small-table mode inside the port: bitwise (both
    copy the same rows at the same index);
  * sampled light points and pdfs: rtol 1e-6 / 1e-5 (the same f32
    arithmetic; reductions and sin/cos may differ by an ulp); the sphere
    cone's points atol 1e-5 (its sqrt of a cancelling difference magnifies
    an ulp);
  * principled ``scatter`` / ``principled_eval``: the GGX tolerances of
    tests/test_torch_shading.py (directions and weights atol 1e-5, pdf
    rtol 5e-4, eval rtol 1e-4);
  * one bounce: radiance atol 1e-5, discrete outcomes equal;
  * the render: ≤ 1% of pixels over 1e-3, means within 1%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.models import progressive as jprog
from pathtracing_tpu.models import scene as jscene_mod
from pathtracing_tpu.models import scenes as jscenes
from pathtracing_tpu.models import shading as jshading
from pathtracing_tpu.ops import lights as jlights
from pathtracing_tpu.ops import materials as jmat
from pathtracing_tpu.ops.camera import build_camera as jcamera
from pathtracing_tpu.utils.config import RenderConfig as JConfig
from pathtracing_tpu_torch.models import progressive as tprog
from pathtracing_tpu_torch.models import scene as tscene_mod
from pathtracing_tpu_torch.models import scenes as tscenes
from pathtracing_tpu_torch.models import shading as tshading
from pathtracing_tpu_torch.ops import camera as tcamera
from pathtracing_tpu_torch.ops import lights as tlights
from pathtracing_tpu_torch.ops import materials as tmat
from pathtracing_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(2)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_light_tables_equal(lj, lt):
    for f in tlights.LightTable._fields:
        a, b = getattr(lj, f), getattr(lt, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        a, b = _np(a), _np(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f


@pytest.fixture(scope="module")
def demo():
    """(JAX scene, port scene, camera config) of many_lights_demo."""
    scene_j, cam_cfg = jscenes.many_lights_demo()
    scene_t, _ = tscenes.many_lights_demo(device="cpu")
    return scene_j, scene_t, cam_cfg


def test_demo_is_in_gather_mode_with_equal_tables(demo):
    scene_j, scene_t, _ = demo
    lt = scene_t.lights
    assert tlights._GATHER_MIN == jlights._GATHER_MIN == 192
    assert lt.cum.shape[0] == 288 and lt.kind is None
    assert tuple(lt.packed.shape) == (288, tlights._P_WIDTH)
    assert (tlights._P_WIDTH, tlights._P_KIND, tlights._P_TEX) == (
        jlights._P_WIDTH, jlights._P_KIND, jlights._P_TEX)
    _assert_light_tables_equal(scene_j.lights, lt)
    for f in ("mat_type", "mat_albedo", "mat_param", "mat_emit",
              "mat_metallic", "sph_center", "tri_v0", "tri_mat"):
        assert _np(getattr(scene_j, f)).tobytes() == _np(
            getattr(scene_t, f)).tobytes(), f
    assert scene_j.mat_clearcoat is None and scene_t.mat_clearcoat is None


def test_small_tables_stay_unpacked():
    scene_t, _ = tscenes.cornell_bsdf(device="cpu")
    assert scene_t.lights.packed is None and scene_t.lights.kind is None
    assert scene_t.mat_metallic is None


def test_gather_mode_pick_indices_equal(demo):
    scene_j, scene_t, _ = demo
    lj, lt = scene_j.lights, scene_t.lights
    u0 = np.random.RandomState(0).rand(8192).astype(np.float32)
    # Include the CDF's own values: the pick is Σ(u > cum), strict.
    u0[:288] = np.asarray(lj.cum)
    u0[288:291] = (0.0, 1.0, np.nextafter(np.float32(1.0), np.float32(0)))
    count = np.clip((u0[:, None] > np.asarray(lj.cum)[None]).sum(1), 0, 287)
    sel3, _ = jlights._pick_and_select(lj, jnp.asarray(u0))
    np.testing.assert_array_equal(np.asarray(sel3("v0")),
                                  np.asarray(lj.v0)[count])
    tidx = tlights.pick(lt, torch.as_tensor(u0)).numpy()
    np.testing.assert_array_equal(count, tidx)
    # The small-table count gives the same index on the same CDF.
    np.testing.assert_array_equal(
        tidx, tlights.pick(lt._replace(packed=None),
                           torch.as_tensor(u0)).numpy())
    assert len(np.unique(tidx)) > 250


def _sample_inputs(n, seed):
    rs = np.random.RandomState(seed)
    u = rs.rand(n, 3).astype(np.float32)
    origin = (rs.rand(n, 3) * 6.0 - 3.0).astype(np.float32)
    return u, origin


def test_gather_mode_matches_small_table_mode_bitwise(demo):
    _, scene_t, _ = demo
    lt = scene_t.lights
    small = lt._replace(packed=None)
    u, origin = (torch.as_tensor(x) for x in _sample_inputs(8192, 7))
    for a, b in zip(tlights.sample(lt, u), tlights.sample(small, u)):
        assert torch.equal(a, b)
    for a, b in zip(tlights.sample_solid_angle(lt, u, origin),
                    tlights.sample_solid_angle(small, u, origin)):
        assert torch.equal(a, b)


def test_gather_mode_sampling_matches_jax(demo):
    scene_j, scene_t, _ = demo
    u, origin = _sample_inputs(4096, 1)
    pj, nj, ej, pdfj = jlights.sample_solid_angle(
        scene_j.lights, jnp.asarray(u), jnp.asarray(origin))
    pt, nt, et, pdft = tlights.sample_solid_angle(
        scene_t.lights, torch.as_tensor(u), torch.as_tensor(origin))
    np.testing.assert_allclose(np.asarray(pj), pt.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(nj), nt.numpy())
    np.testing.assert_array_equal(np.asarray(ej), et.numpy())
    np.testing.assert_allclose(np.asarray(pdfj), pdft.numpy(), rtol=1e-5)


def _sphere_light_scenes():
    """Two emissive spheres and three emissive triangles of different
    power, so the table carries the ``kind`` column."""
    out = []
    for mod in (jscene_mod, tscene_mod):
        b = mod.SceneBuilder()
        floor = b.lambertian((0.5, 0.5, 0.5))
        b.add_quad((-2, -1, -2), (4, 0, 0), (0, 0, 4), floor)
        rs = np.random.RandomState(3)
        for i in range(3):
            m = b.emissive(tuple(rs.rand(3) * 10.0 + 0.1))
            v = rs.randn(3) + rs.randn(3, 3) * 0.3
            b.add_triangle(v[0], v[1], v[2], m)
        b.add_sphere((0.5, 1.0, 0.0), 0.4, b.emissive((8.0, 6.0, 4.0)))
        b.add_sphere((-1.0, 0.5, 1.0), 0.15, b.emissive((30.0, 30.0, 30.0)))
        b.add_sphere((0.0, -0.5, 0.0), 0.3, floor)
        out.append(b)
    return out


@pytest.fixture(scope="module", params=["small", "gather"])
def sphere_lights(request):
    """(JAX table, port table) with sphere emitters, in small-table mode
    and with the gather threshold forced down to 1 in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "gather":
            mp.setattr(jlights, "_GATHER_MIN", 1)
            mp.setattr(tlights, "_GATHER_MIN", 1)
        bj, bt = _sphere_light_scenes()
        lj, lt = bj.build().lights, bt.build("cpu").lights
    assert (lt.packed is not None) == (request.param == "gather")
    return lj, lt


def test_sphere_light_tables_equal(sphere_lights):
    lj, lt = sphere_lights
    assert lt.kind.tolist() == [0, 0, 0, 1, 1]
    _assert_light_tables_equal(lj, lt)


def test_sphere_light_sampling_matches_jax(sphere_lights):
    lj, lt = sphere_lights
    u, origin = _sample_inputs(4096, 2)
    # Some shading points inside the first emissive sphere: the
    # area-uniform fallback.
    origin[:64] = np.array([0.5, 1.0, 0.0], np.float32) + (
        origin[:64] * 0.03)
    pj, nj, ej = jlights.sample(lj, jnp.asarray(u))
    pt, nt, et = tlights.sample(lt, torch.as_tensor(u))
    np.testing.assert_allclose(np.asarray(pj), pt.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(nj), nt.numpy(), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ej), et.numpy())
    pj, nj, ej, pdfj = jlights.sample_solid_angle(lj, jnp.asarray(u),
                                                  jnp.asarray(origin))
    pt, nt, et, pdft = tlights.sample_solid_angle(lt, torch.as_tensor(u),
                                                  torch.as_tensor(origin))
    np.testing.assert_allclose(np.asarray(pj), pt.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(nj), nt.numpy(), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(ej), et.numpy())
    np.testing.assert_allclose(np.asarray(pdfj), pdft.numpy(), rtol=1e-4)
    assert np.isfinite(pdft.numpy()).all() and (pdft.numpy() > 0).all()


def test_scene_from_numpy_carries_light_and_material_columns(demo):
    scene_j, scene_t, _ = demo
    s = tscene_mod.scene_from_numpy(jax.tree.map(np.asarray, scene_j), "cpu")
    _assert_light_tables_equal(s.lights, scene_t.lights)
    assert torch.equal(s.mat_metallic, scene_t.mat_metallic)
    bj, bt = _sphere_light_scenes()
    coat = bj.principled((0.8, 0.2, 0.2), metallic=0.3, clearcoat=0.7)
    bj.add_sphere((2.0, 0.0, 0.0), 0.2, coat)
    s = tscene_mod.scene_from_numpy(jax.tree.map(np.asarray, bj.build()),
                                    "cpu")
    assert s.lights.kind.tolist() == [0, 0, 0, 1, 1]
    assert tuple(s.mat_clearcoat.shape) == (s.mat_type.shape[0], 2)
    assert float(s.mat_clearcoat[coat, 0]) == np.float32(0.7)


# --- the principled lobe ---------------------------------------------------


def _hemisphere_inputs(n, seed):
    rs = np.random.RandomState(seed)
    normal = rs.randn(n, 3)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    d_in = rs.randn(n, 3)
    d_in /= np.linalg.norm(d_in, axis=1, keepdims=True)
    flip = (d_in * normal).sum(1) > 0
    d_in[flip] *= -1
    return normal.astype(np.float32), d_in.astype(np.float32), rs


def _principled_columns(n, rs, coat):
    base = rs.rand(n, 3).astype(np.float32)
    metallic = rs.rand(n).astype(np.float32)
    rough = (rs.rand(n) * 0.9 + 0.05).astype(np.float32)
    cc = None
    if coat:
        cc = np.stack([rs.rand(n), rs.rand(n) * 0.5 + 0.05],
                      axis=1).astype(np.float32)
        cc[::5, 0] = 0.0            # uncoated rows in a coated scene
    return base, metallic, rough, cc


@pytest.mark.parametrize("coat", [False, True])
def test_principled_eval_matches(coat):
    n = 2048
    normal, view, rs = _hemisphere_inputs(n, 11)
    view = -view
    light = rs.randn(n, 3).astype(np.float32)
    light /= np.linalg.norm(light, axis=1, keepdims=True)
    base, metallic, rough, cc = _principled_columns(n, rs, coat)
    fj, pj = jmat.principled_eval(
        *(jnp.asarray(x) for x in (base, metallic, rough, normal, view,
                                   light)),
        clearcoat=None if cc is None else jnp.asarray(cc))
    ft, pt = tmat.principled_eval(
        *(torch.as_tensor(x) for x in (base, metallic, rough, normal, view,
                                       light)),
        clearcoat=None if cc is None else torch.as_tensor(cc))
    np.testing.assert_allclose(np.asarray(fj), ft.numpy(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(pj), pt.numpy(), rtol=1e-4,
                               atol=1e-6)
    assert (pt.numpy() > 0).mean() > 0.3


@pytest.mark.parametrize("coat", [False, True])
def test_principled_scatter_matches(coat):
    n = 2048
    normal, d_in, rs = _hemisphere_inputs(n, 13)
    base, metallic, rough, cc = _principled_columns(n, rs, coat)
    emit = np.zeros((n, 3), np.float32)
    front = rs.rand(n) > 0.3
    u = rs.rand(n, 5).astype(np.float32)
    # Principled rows beside Lambertian ones: the other lobes must stay
    # as they are in a scene that carries the metallic column.
    mt = np.where(np.arange(n) % 4 == 3, tmat.TYPE_LAMBERTIAN,
                  tmat.TYPE_PRINCIPLED).astype(np.int32)
    args = (mt, base, rough, emit, normal, d_in, front, u)
    out_j = jmat.scatter(
        *(jnp.asarray(x) for x in args), metallic=jnp.asarray(metallic),
        clearcoat=None if cc is None else jnp.asarray(cc))
    out_t = tmat.scatter(
        *(torch.as_tensor(x) for x in args),
        metallic=torch.as_tensor(metallic),
        clearcoat=None if cc is None else torch.as_tensor(cc))
    d_j, a_j, s_j, p_j = (np.asarray(x) for x in out_j)
    d_t, a_t, s_t, p_t = (x.numpy() for x in out_t)
    # A lane whose lobe pick or accept test sits within float noise of its
    # threshold may flip; everything else must agree.
    agree = (s_j == s_t) & (np.abs(d_j - d_t).max(axis=1) < 1e-3)
    assert agree.mean() > 0.995
    np.testing.assert_allclose(d_j[agree], d_t[agree], atol=1e-5)
    np.testing.assert_allclose(a_j[agree], a_t[agree], atol=2e-5,
                               rtol=5e-4)
    np.testing.assert_allclose(p_j[agree], p_t[agree], atol=1e-5,
                               rtol=5e-4)
    plain = tmat.scatter(*(torch.as_tensor(x) for x in args))
    lam = torch.as_tensor(mt == tmat.TYPE_LAMBERTIAN)
    for a, b in zip(out_t, plain):
        assert torch.equal(a[lam], b[lam])


# --- the slice as a whole --------------------------------------------------


def test_one_bounce_on_many_lights_matches(demo):
    """A whole bounce of many_lights_demo (gather-mode NEE, the principled
    sphere, GGX floor) from the same rays and keys."""
    scene_j, scene_t, cam_cfg = demo
    cfg = TConfig(width=24, height=24)
    cam_t = tcamera.build_camera(cam_cfg, 1.0, device="cpu")
    pix = torch.arange(576, dtype=torch.int64)
    keys, o, d = tshading.camera_sample(cam_t, cfg, 0, pix, 1)
    keys_j = jax.random.wrap_key_data(
        jnp.asarray(keys.numpy().astype(np.uint32)))
    rs = np.random.RandomState(4)
    tp = rs.rand(576, 3).astype(np.float32)
    active = rs.rand(576) > 0.1
    out_j = jshading.bounce_batch(
        scene_j, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), keys_j,
        1, jnp.zeros((576, 3)), jnp.asarray(tp), jnp.asarray(active),
        8, "black", "cluster_jax", nee=True)
    out_t = tshading.bounce_batch(
        scene_t, o, d, keys, 1, torch.zeros((576, 3)), torch.as_tensor(tp),
        torch.as_tensor(active), 8, "black", "cluster_torch", nee=True)
    np.testing.assert_array_equal(np.asarray(out_j[4]), out_t[4].numpy())
    np.testing.assert_array_equal(np.asarray(out_j[6]), out_t[6].numpy())
    np.testing.assert_allclose(np.asarray(out_j[0]), out_t[0].numpy(),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(out_j[1]), out_t[1].numpy(),
                               atol=1e-5, rtol=1e-4)
    assert out_t[0].numpy().max() > 0.0


def test_many_lights_demo_render_matches_jax(demo):
    """Seed 0 (as 3 and 4) agrees to 5e-4 on every pixel. Seeds 1 and 2
    each send one mirror ray out along the edge of a ceiling panel, where
    the jitted JAX render and eager arithmetic (torch's, and JAX's own
    outside ``jit``) fall on different sides; that one panel-bright pixel
    moves the 32×32 mean by 2%, past the 1% this test allows."""
    scene_j, scene_t, cam_cfg = demo
    kw = dict(width=32, height=32, samples_per_pixel=2, max_depth=4,
              seed=0, nee=True)
    img_j = np.asarray(jprog.render_once(
        scene_j, jcamera(cam_cfg, 1.0), JConfig(traversal="cluster_jax",
                                                **kw)))
    img_t = tprog.render_once(
        scene_t, tcamera.build_camera(cam_cfg, 1.0, device="cpu"),
        TConfig(**kw)).numpy()
    assert img_t.shape == (32, 32, 3) and np.isfinite(img_t).all()
    diff = np.abs(img_j - img_t).max(axis=-1)
    assert (diff > 1e-3).mean() <= 0.01
    assert abs(img_t.mean() - img_j.mean()) <= 0.01 * img_j.mean()
    assert img_t.mean() > 0.01
