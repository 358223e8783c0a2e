"""Port parity (e): light picks, light sampling, materials, camera rays,
binning and one whole bounce, fed the same numpy inputs in both packages.

Tolerances and why:
  * light pick indices, binning permutations: exact (integer outputs);
  * light points and pdfs: rtol 1e-6 / 1e-5 — the same f32 arithmetic,
    with the reductions' order free to differ by an ulp;
  * scatter directions and weights: atol 1e-5 — XLA and torch use
    different sin/cos/pow implementations (ulp-level differences); the
    GGX pdf rtol 5e-4 (its NDF peak magnifies those, see the test);
  * one bounce: radiance atol 1e-5, discrete outcomes (active lanes) equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.models import scene as jscene_mod
from pathtracing_tpu.models import shading as jshading
from pathtracing_tpu.ops import binning as jbinning
from pathtracing_tpu.ops import camera as jcamera
from pathtracing_tpu.ops import lights as jlights
from pathtracing_tpu.ops import materials as jmat
from pathtracing_tpu.utils.config import RenderConfig as JConfig
from pathtracing_tpu_torch.models import scene as tscene_mod
from pathtracing_tpu_torch.models import scenes as tscenes
from pathtracing_tpu_torch.models import shading as tshading
from pathtracing_tpu_torch.ops import binning as tbinning
from pathtracing_tpu_torch.ops import camera as tcamera
from pathtracing_tpu_torch.ops import lights as tlights
from pathtracing_tpu_torch.ops import materials as tmat
from pathtracing_tpu_torch.ops import rng as trng
from pathtracing_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(2)


def _many_light_builders():
    """Twenty emissive triangles of different radiance and area, so the
    power CDF has unequal steps (well under the gather-mode size)."""
    out = []
    for mod in (jscene_mod, tscene_mod):
        b = mod.SceneBuilder()
        floor = b.lambertian((0.5, 0.5, 0.5))
        b.add_quad((-2, -1, -2), (4, 0, 0), (0, 0, 4), floor)
        rs = np.random.RandomState(3)
        for i in range(20):
            m = b.emissive(tuple(rs.rand(3) * 10.0 + 0.1))
            c = rs.randn(3)
            v = c + rs.randn(3, 3) * (0.1 + 0.05 * i)
            b.add_triangle(v[0], v[1], v[2], m)
        out.append(b)
    return out


@pytest.fixture(scope="module")
def light_tables():
    bj, bt = _many_light_builders()
    return bj.build().lights, bt.build("cpu").lights


def test_light_tables_equal(light_tables):
    lj, lt = light_tables
    for f in tlights.LightTable._fields:
        a, b = getattr(lj, f), getattr(lt, f)
        if a is None or b is None:      # kind / packed: absent in both
            assert a is None and b is None, f
            continue
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)


def test_light_pick_indices_equal(light_tables):
    lj, lt = light_tables
    u0 = np.random.RandomState(0).rand(4096).astype(np.float32)
    # Include the CDF's own values: the pick is Σ(u > cum), strict.
    u0[:20] = np.asarray(lj.cum)
    sel3, _ = jlights._pick_and_select(lj, jnp.asarray(u0))
    v0_j = np.asarray(sel3("v0"))
    table = np.asarray(lj.v0)
    jidx = np.argmin(np.abs(v0_j[:, None, :] - table[None]).sum(-1), axis=1)
    tidx = tlights.pick(lt, torch.as_tensor(u0)).numpy()
    np.testing.assert_array_equal(jidx, tidx)
    assert len(np.unique(tidx)) == 20


def test_sample_solid_angle_matches(light_tables):
    lj, lt = light_tables
    rs = np.random.RandomState(1)
    u = rs.rand(2048, 3).astype(np.float32)
    origin = (rs.randn(2048, 3) * 0.5).astype(np.float32)
    pj, nj, ej, pdfj = jlights.sample_solid_angle(lj, jnp.asarray(u),
                                                  jnp.asarray(origin))
    pt, nt, et, pdft = tlights.sample_solid_angle(lt, torch.as_tensor(u),
                                                  torch.as_tensor(origin))
    np.testing.assert_allclose(np.asarray(pj), pt.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(nj), nt.numpy())
    np.testing.assert_array_equal(np.asarray(ej), et.numpy())
    np.testing.assert_allclose(np.asarray(pdfj), pdft.numpy(), rtol=1e-5)


def _hemisphere_inputs(n, seed):
    rs = np.random.RandomState(seed)
    normal = rs.randn(n, 3)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    d_in = rs.randn(n, 3)
    d_in /= np.linalg.norm(d_in, axis=1, keepdims=True)
    # Incident directions point against the normal (as after a hit).
    flip = (d_in * normal).sum(1) > 0
    d_in[flip] *= -1
    return normal.astype(np.float32), d_in.astype(np.float32), rs


@pytest.mark.parametrize("mtype", [tmat.TYPE_LAMBERTIAN, tmat.TYPE_METAL,
                                   tmat.TYPE_DIELECTRIC, tmat.TYPE_EMISSIVE,
                                   tmat.TYPE_GGX, tmat.TYPE_CHECKER])
def test_scatter_matches(mtype):
    n = 2048
    normal, d_in, rs = _hemisphere_inputs(n, mtype)
    albedo = rs.rand(n, 3).astype(np.float32)
    param = {tmat.TYPE_METAL: rs.rand(n) * 0.3,
             tmat.TYPE_DIELECTRIC: 1.0 + rs.rand(n),
             tmat.TYPE_GGX: rs.rand(n) * 0.5 + 0.01,
             tmat.TYPE_CHECKER: np.full(n, 3.0)}.get(
        mtype, np.zeros(n)).astype(np.float32)
    emit = rs.rand(n, 3).astype(np.float32)
    front = rs.rand(n) > 0.3
    u = rs.rand(n, 5).astype(np.float32)
    mt = np.full(n, mtype, np.int32)
    out_j = jmat.scatter(*(jnp.asarray(x) for x in (
        mt, albedo, param, emit, normal, d_in, front, u)))
    out_t = tmat.scatter(*(torch.as_tensor(x) for x in (
        mt, albedo, param, emit, normal, d_in, front, u)))
    d_j, a_j, s_j, p_j = (np.asarray(x) for x in out_j)
    d_t, a_t, s_t, p_t = (x.numpy() for x in out_t)
    # A lane whose accept test sits within float noise of its threshold
    # may flip; everything else must agree.
    agree = s_j == s_t
    assert agree.mean() > 0.999
    np.testing.assert_allclose(d_j[agree], d_t[agree], atol=1e-5)
    np.testing.assert_allclose(a_j[agree], a_t[agree], atol=1e-5,
                               rtol=1e-5)
    # The GGX pdf's NDF term D = α²/(π (c²(α²-1)+1)²) peaks near 4e8 for
    # α = 0.01: its cancelling denominator magnifies ulp-level cos_h
    # differences to ~2e-4 relative.
    np.testing.assert_allclose(p_j[agree], p_t[agree], atol=1e-5,
                               rtol=5e-4)


def test_ggx_eval_and_albedo_helpers_match():
    n = 1024
    normal, view, rs = _hemisphere_inputs(n, 7)
    view = -view
    light = rs.randn(n, 3).astype(np.float32)
    light /= np.linalg.norm(light, axis=1, keepdims=True)
    f0 = rs.rand(n, 3).astype(np.float32)
    alpha = (rs.rand(n) * 0.6).astype(np.float32)
    fj, pj = jmat.ggx_eval(*(jnp.asarray(x) for x in (f0, alpha, normal,
                                                      view, light)))
    ft, pt = tmat.ggx_eval(*(torch.as_tensor(x) for x in (f0, alpha, normal,
                                                          view, light)))
    np.testing.assert_allclose(np.asarray(fj), ft.numpy(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(pj), pt.numpy(), rtol=1e-4,
                               atol=1e-6)
    mt = rs.randint(0, 6, n).astype(np.int32)
    pos = (rs.randn(n, 3) * 2).astype(np.float32)
    emit = rs.rand(n, 3).astype(np.float32)
    args = (mt, f0, alpha + 1.0, emit, pos)
    np.testing.assert_array_equal(
        np.asarray(jmat.effective_albedo(*(jnp.asarray(x) for x in args))),
        tmat.effective_albedo(*(torch.as_tensor(x) for x in args)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jmat.effective_emission(jnp.asarray(mt),
                                           jnp.asarray(emit))),
        tmat.effective_emission(torch.as_tensor(mt),
                                torch.as_tensor(emit)).numpy())
    for fn in ("is_diffuse_type", "is_nee_type"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jmat, fn)(jnp.asarray(mt))),
            getattr(tmat, fn)(torch.as_tensor(mt)).numpy())


@pytest.mark.parametrize("sampler", ["ld", "independent"])
def test_camera_sample_matches(sampler):
    from pathtracing_tpu.models.scenes import CORNELL_CAMERA

    jcfg = JConfig(width=40, height=30, sampler=sampler)
    tcfg = TConfig(width=40, height=30, sampler=sampler)
    cam_j = jcamera.build_camera(CORNELL_CAMERA, 40 / 30)
    cam_t = tcamera.build_camera(CORNELL_CAMERA, 40 / 30, device="cpu")
    pix = np.arange(1200, dtype=np.int32)
    kj, oj, dj = jax.vmap(lambda p: jshading.camera_sample(
        cam_j, jcfg, jnp.uint32(9), p, jnp.int32(4)))(jnp.asarray(pix))
    kt, ot, dt = tshading.camera_sample(cam_t, tcfg, 9,
                                        torch.as_tensor(pix).long(), 4)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(kj)).astype(np.int64), kt.numpy())
    np.testing.assert_allclose(np.asarray(oj), ot.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(dj), dt.numpy(), atol=1e-6)


def test_binning_perm_matches():
    bins = np.random.RandomState(2).randint(0, 2, 777).astype(np.int32)
    pj, ij = jbinning.binning_perm(jnp.asarray(bins), 2)
    pt, it = tbinning.binning_perm(torch.as_tensor(bins))
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())


@pytest.mark.parametrize("depth", [0, 2])
def test_one_bounce_matches(depth):
    """A whole bounce (hit, emission, NEE with MIS, scatter) from the same
    rays and keys: the same discrete outcomes and radiance."""
    from pathtracing_tpu.models.scenes import CORNELL_CAMERA, cornell_bsdf

    scene_j, _ = cornell_bsdf()
    scene_t, _ = tscenes.cornell_bsdf(device="cpu")
    cfg = TConfig(width=24, height=24)
    cam_t = tcamera.build_camera(CORNELL_CAMERA, 1.0, device="cpu")
    pix = torch.arange(576, dtype=torch.int64)
    keys, o, d = tshading.camera_sample(cam_t, cfg, 0, pix, 1)
    keys_j = jax.random.wrap_key_data(
        jnp.asarray(keys.numpy().astype(np.uint32)))
    rs = np.random.RandomState(depth)
    tp = rs.rand(576, 3).astype(np.float32)
    prev_pdf = (rs.rand(576) + 0.1).astype(np.float32)
    prev_nee = rs.rand(576) > 0.5
    active = rs.rand(576) > 0.1
    out_j = jshading.bounce_batch(
        scene_j, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), keys_j,
        depth, jnp.zeros((576, 3)), jnp.asarray(tp), jnp.asarray(active),
        8, "black", "cluster_jax", nee=True,
        prev_pdf=jnp.asarray(prev_pdf), prev_nee=jnp.asarray(prev_nee),
    )
    out_t = tshading.bounce_batch(
        scene_t, o, d, keys, depth, torch.zeros((576, 3)),
        torch.as_tensor(tp), torch.as_tensor(active), 8, "black",
        "cluster_torch", nee=True, prev_pdf=torch.as_tensor(prev_pdf),
        prev_nee=torch.as_tensor(prev_nee),
    )
    rad_j, rad_t = np.asarray(out_j[0]), out_t[0].numpy()
    np.testing.assert_array_equal(np.asarray(out_j[4]), out_t[4].numpy())
    np.testing.assert_array_equal(np.asarray(out_j[6]), out_t[6].numpy())
    np.testing.assert_allclose(rad_j, rad_t, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(out_j[1]), out_t[1].numpy(),
                               atol=1e-5, rtol=1e-5)
    live = out_t[4].numpy()
    np.testing.assert_allclose(np.asarray(out_j[3])[live],
                               out_t[3].numpy()[live], atol=1e-5)
    assert rad_t.max() > 0.0
