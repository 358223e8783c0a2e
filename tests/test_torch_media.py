"""Port parity: participating media (``ops/sampling.hg_*``,
``ops/volume.py``, the media blocks of ``shading.bounce_batch`` and the
four media scenes).

  * ``hg_phase`` / ``hg_sample``: within 1e-6 (HG frames use sin/cos,
    whose XLA and torch versions differ by an ulp on some inputs);
  * ``build_grid``: every table bit for bit (density, majorant, the
    coarse and per-ray majorant grids, emission) and the integers
    ``n_steps`` / ``ray_samples`` equal, with and without the coarse
    grids, with emission; the same ``ValueError`` messages;
  * ``density_at`` / ``emission_at``: bit for bit;
  * ``sample_distance`` on fixed keys and per-lane depths: events and
    the phase uniforms equal, the event distance within 1e-6 relative
    (measured: 1.1e-7, the prefix sum's rounding); ``transmittance``
    within 2e-6 absolute (measured: 1.25e-6 on one lane of 3,000, under
    4e-7 on the others: the order in which each round's K ratios are
    multiplied, over up to 64 rounds);
  * the sequential walks against the batched ones in mean, within five
    standard errors (the same estimator on other streams);
  * ``render_once`` of fog_demo, smoke_demo, fire_demo and sss_demo at
    depth 6 (roulette and the compaction at 3, which permutes ``sss``)
    and the wavefront engine on fog_demo and sss_demo against the JAX
    CPU renders at 24x24, 2 spp: measured largest per-pixel differences
    1.6e-5, 1.4e-4, 1.4e-5 and 7.7e-6, no pixel above 1e-3; the test
    holds the render tolerance of tests/test_torch_render.py (1% of
    pixels above 1e-3, means within 1%). The wavefront equals the port's
    megakernel bit for bit.

Every ``Scene`` field of the four scenes, ``fog``, ``vol`` and
``mat_interior`` included, is held bit for bit by
tests/test_torch_scenes.py, and the builder's refusals there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.models import progressive as jprog
from pathtracing_tpu.models import scenes as jscenes
from pathtracing_tpu.models import wavefront as jwave
from pathtracing_tpu.ops import bvh_native
from pathtracing_tpu.ops import sampling as jsamp
from pathtracing_tpu.ops import volume as jvol
from pathtracing_tpu.ops.camera import build_camera as jcamera
from pathtracing_tpu.utils.config import RenderConfig as JConfig
from pathtracing_tpu_torch.models import progressive as tprog
from pathtracing_tpu_torch.models import scenes as tscenes
from pathtracing_tpu_torch.models import wavefront as twave
from pathtracing_tpu_torch.ops import rng as trng
from pathtracing_tpu_torch.ops import sampling as tsamp
from pathtracing_tpu_torch.ops import volume as tvol
from pathtracing_tpu_torch.ops.camera import build_camera as tcamera
from pathtracing_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(2)

BMIN, BMAX = (-0.62, -1.0, -0.52), (0.38, 0.7, 0.48)


@pytest.fixture(scope="module")
def density():
    return tscenes.smoke_density()


def test_smoke_density_matches_jax(density):
    assert density.tobytes() == jscenes.smoke_density().tobytes()


@pytest.mark.parametrize("g", [-0.7, 0.0, 5e-4, 0.4, "per lane"])
def test_hg_phase_and_sample_match_jax(g):
    rs = np.random.RandomState(3)
    n = 2000
    d = rs.randn(n, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    u1, u2 = rs.rand(n).astype(np.float32), rs.rand(n).astype(np.float32)
    gv = (rs.rand(n).astype(np.float32) * 1.8 - 0.9 if g == "per lane"
          else np.float32(g))
    dj, cj = jsamp.hg_sample(jnp.asarray(d), jnp.asarray(gv), jnp.asarray(u1),
                             jnp.asarray(u2))
    dt, ct = tsamp.hg_sample(torch.as_tensor(d), torch.as_tensor(gv),
                             torch.as_tensor(u1), torch.as_tensor(u2))
    np.testing.assert_allclose(np.asarray(cj), ct.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(dj), dt.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(dt.numpy(), axis=1), 1.0,
                               atol=1e-6)
    pj = jsamp.hg_phase(jnp.asarray(gv), cj)
    pt = tsamp.hg_phase(torch.as_tensor(gv), ct)
    np.testing.assert_allclose(np.asarray(pj), pt.numpy(), rtol=1e-5)


GRID_CASES = {
    "coarse": {},
    "global majorant": {"coarse_block": 0},
    "emission": {"emission": "dens2", "emit_color": (14.0, 5.5, 1.6),
                 "sigma_a": 6.0},
    "coarse 5, n_steps": {"coarse_block": 5, "n_steps": 40},
}


def _grids(density, case):
    kw = {"sigma_s": 14.0, "sigma_a": 1.2, "g": 0.25, **GRID_CASES[case]}
    if kw.get("emission") == "dens2":
        kw["emission"] = density * density
    return (jvol.build_grid(density, BMIN, BMAX, **kw),
            tvol.build_grid(density, BMIN, BMAX, **kw))


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_build_grid_tables_match_jax(density, case):
    jv, tv = _grids(density, case)
    for f in dataclasses.fields(tvol.VolumeGrid):
        a, b = getattr(jv, f.name), getattr(tv, f.name)
        assert (a is None) == (b is None), f.name
        if isinstance(b, int):
            assert a == b, f.name
        elif b is not None:
            a = np.asarray(a)
            assert a.dtype == b.numpy().dtype and a.shape == tuple(b.shape)
            assert a.tobytes() == b.numpy().tobytes(), f.name
    assert float(jv.albedo) == float(tv.albedo)


def _refusal(build, *args, **kw):
    try:
        build(*args, **kw)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("args,kw", [
    ((np.ones((4, 4)), BMIN, BMAX, 1.0), {}),
    ((-np.ones((2, 2, 2)), BMIN, BMAX, 1.0), {}),
    ((np.ones((2, 2, 2)), BMIN, BMAX, 0.0), {}),
    ((np.ones((2, 2, 2)), BMAX, BMIN, 1.0), {}),
    ((np.ones((2, 2, 2)), BMIN, BMAX, 1.0), {"emission": np.ones((2, 2))}),
    ((np.ones((2, 2, 2)), BMIN, BMAX, 1.0),
     {"emission": np.ones((2, 2, 2))}),
])
def test_build_grid_refusals_match_jax(args, kw):
    msg = _refusal(tvol.build_grid, *args, **kw)
    assert msg is not None and msg == _refusal(jvol.build_grid, *args, **kw)


@pytest.mark.parametrize("case", ["coarse", "emission"])
def test_density_and_emission_match_jax(density, case):
    jv, tv = _grids(density, case)
    rs = np.random.RandomState(1)
    x = (rs.rand(5000, 3) * 1.4 - 0.7).astype(np.float32)
    x[:10] = np.asarray(BMIN, np.float32)      # the box's own corners
    x[10:20] = np.asarray(BMAX, np.float32)
    np.testing.assert_array_equal(np.asarray(jvol.density_at(jv, x)),
                                  tvol.density_at(tv, torch.as_tensor(x)))
    if case == "emission":
        np.testing.assert_array_equal(
            np.asarray(jvol.emission_at(jv, x)),
            tvol.emission_at(tv, torch.as_tensor(x)))


def _walk_inputs(n, seed):
    """Rays from around the grid through it, per-lane depths, dead lanes
    and caps (some inside the box), keys of a fixed seed."""
    rs = np.random.RandomState(seed)
    center = (np.asarray(BMIN) + np.asarray(BMAX)) / 2
    o = (center + rs.randn(n, 3) * 0.8).astype(np.float32)
    tgt = center + rs.randn(n, 3) * 0.2
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = np.where(rs.rand(n) > 0.3, rs.rand(n) * 2.5,
                     3.0e38).astype(np.float32)
    active = rs.rand(n) > 0.1
    depth = rs.randint(0, 7, n)
    keys = trng.pixel_sample_key(seed, torch.arange(n), 3)
    keys_j = jax.random.wrap_key_data(
        jnp.asarray(keys.numpy().astype(np.uint32)))
    return o, d, t_max, active, depth, keys, keys_j


@pytest.mark.parametrize("case", ["coarse", "global majorant"])
def test_sample_distance_matches_jax(density, case):
    jv, tv = _grids(density, case)
    o, d, t_max, active, depth, keys, keys_j = _walk_inputs(3000, 2)
    ej, tj, uj = (np.asarray(x) for x in jvol.sample_distance(
        jv, keys_j, jnp.asarray(depth.astype(np.int32)), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(t_max), jnp.asarray(active)))
    et, tt, ut = (x.numpy() for x in tvol.sample_distance(
        tv, keys, torch.as_tensor(depth), torch.as_tensor(o),
        torch.as_tensor(d), torch.as_tensor(t_max),
        torch.as_tensor(active)))
    np.testing.assert_array_equal(ej, et)
    np.testing.assert_array_equal(uj, ut)
    assert 300 < ej.sum() < 2700
    np.testing.assert_allclose(tt[ej], tj[ej], rtol=1e-6)
    # No event: the clipped segment's exit, as JAX gives it.
    np.testing.assert_array_equal(np.isfinite(tj), np.isfinite(tt))
    fin = np.isfinite(tj) & ~ej
    np.testing.assert_allclose(tt[fin], tj[fin], rtol=1e-6)


@pytest.mark.parametrize("salt", [tvol.SALT_NEE, tvol.SALT_DELTA])
def test_transmittance_matches_jax(density, salt):
    jv, tv = _grids(density, "coarse")
    o, d, t_max, _, depth, keys, keys_j = _walk_inputs(3000, 4)
    trj = np.asarray(jvol.transmittance(
        jv, keys_j, jnp.asarray(depth.astype(np.int32)), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(t_max), salt))
    args = (tv, keys, torch.as_tensor(depth), torch.as_tensor(o),
            torch.as_tensor(d), torch.as_tensor(t_max), salt)
    trt = tvol.transmittance(*args).numpy()
    np.testing.assert_allclose(trt, trj, atol=2e-6)
    assert 0.2 < (trj < 1.0).mean() and trj.min() < 0.5
    # ``active`` restricts the walk and changes no walked lane.
    some = np.random.RandomState(0).rand(3000) > 0.5
    part = tvol.transmittance(*args, active=torch.as_tensor(some)).numpy()
    np.testing.assert_array_equal(part[some], trt[some])
    assert (part[~some] == 1.0).all()


def test_sequential_walks_agree_in_mean(density):
    """The per-cell sequential walks and the batched walks estimate the
    same quantities on other streams: the event rate and the mean
    transmittance agree within five standard errors."""
    _, tv = _grids(density, "coarse")
    o, d, t_max, active, depth, keys, _ = _walk_inputs(6000, 6)
    args = (tv, keys, torch.as_tensor(depth), torch.as_tensor(o),
            torch.as_tensor(d), torch.as_tensor(t_max))
    e_b = tvol.sample_distance(*args, torch.as_tensor(active))[0].numpy()
    e_s = tvol.sample_distance_seq(*args, torch.as_tensor(active))[0].numpy()
    se = np.sqrt(e_b.mean() * (1 - e_b.mean()) / e_b.size)
    assert abs(e_b.mean() - e_s.mean()) < 5 * np.sqrt(2) * se
    t_b = tvol.transmittance(*args, tvol.SALT_ENV).numpy()
    t_s = tvol.transmittance_seq(*args, tvol.SALT_ENV).numpy()
    se_t = np.sqrt(t_b.var() / t_b.size + t_s.var() / t_s.size)
    assert abs(t_b.mean() - t_s.mean()) < 5 * se_t


# --- renders ---------------------------------------------------------------

MEDIA = ("fog_demo", "smoke_demo", "fire_demo", "sss_demo")
KW = dict(width=24, height=24, samples_per_pixel=2, samples_per_step=2,
          max_depth=6, rr_start_depth=3, seed=1, nee=True)


def _pair(name):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bvh_native, "build", lambda *a, **k: None)
        sj, cc = jscenes.get_scene(name)
    st, _ = tscenes.get_scene(name, device="cpu")
    return sj, st, cc, {**KW, "background": tscenes.preferred_background(
        name)}


def _assert_render_close(img_j, img_t):
    assert img_t.shape == img_j.shape and np.isfinite(img_t).all()
    diff = np.abs(img_j - img_t).max(axis=-1)
    assert (diff > 1e-3).mean() <= 0.01
    assert abs(img_t.mean() - img_j.mean()) <= 0.01 * img_j.mean()


@pytest.mark.parametrize("name", MEDIA)
def test_render_once_matches_jax(name):
    sj, st, cc, kw = _pair(name)
    img_j = np.asarray(jprog.render_once(
        sj, jcamera(cc, 1.0), JConfig(traversal="cluster_jax", **kw)))
    img_t = tprog.render_once(st, tcamera(cc, 1.0, device="cpu"),
                              TConfig(**kw)).numpy()
    _assert_render_close(img_j, img_t)
    assert img_t.mean() > 0.02


@pytest.mark.parametrize("name", ["fog_demo", "sss_demo"])
def test_wavefront_matches_jax_wavefront(name):
    sj, st, cc, kw = _pair(name)
    jc = JConfig(traversal="cluster_jax", **kw)
    state = jwave.render_step(jprog.init_state(jc), sj, jcamera(cc, 1.0), jc)
    img_j = np.asarray(jprog.resolve(state))
    cam = tcamera(cc, 1.0, device="cpu")
    tc = TConfig(**kw)
    img_t = tprog.resolve(twave.render_step(
        tprog.init_state(tc, device="cpu"), st, cam, tc)).numpy()
    _assert_render_close(img_j, img_t)
    img_m = tprog.resolve(tprog.render_step(
        tprog.init_state(tc, device="cpu"), st, cam, tc)).numpy()
    np.testing.assert_array_equal(img_t, img_m)


def test_media_free_scenes_draw_no_media_stream(monkeypatch):
    """A scene without media never folds STREAM_FOG, STREAM_VOL,
    STREAM_VOLT or STREAM_SSS into a key, and the megakernel state of a
    scatter-free scene carries no ``sss`` row."""
    media = {trng.STREAM_FOG, trng.STREAM_VOL, trng.STREAM_VOLT,
             trng.STREAM_SSS}
    seen = set()
    fold = trng.fold_in

    def spy(k, data):
        if isinstance(data, int):
            seen.add(data)
        return fold(k, data)

    monkeypatch.setattr(trng, "fold_in", spy)
    st, cc = tscenes.glass_demo(device="cpu")
    cfg = TConfig(**{**KW, "width": 8, "height": 8})
    tprog.render_once(st, tcamera(cc, 1.0, device="cpu"), cfg)
    assert not seen & media and trng.STREAM_SCATTER in seen
    seen.clear()
    st, cc = tscenes.fog_demo(device="cpu")
    tprog.render_once(st, tcamera(cc, 1.0, device="cpu"), cfg)
    assert trng.STREAM_FOG in seen and not seen & (media - {trng.STREAM_FOG})
