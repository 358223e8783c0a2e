"""Port parity: the wavefront engine (``models/wavefront.py``) and the
per-ray depth counters of ``shading.bounce_batch``.

One bounce with a mixed (R,) depth (0 to 9, past ``rr_start_depth``)
matches the JAX bounce under both samplers: discrete outcomes equal,
radiance, throughput and directions within 1e-5 (the tolerance of
tests/test_torch_shading.py's one-bounce test: ulp-level differences of
XLA's and torch's sin/cos/pow). A tensor depth gives the int depth's
bounce bit for bit on lanes of one depth.

Renders at 24x24, 2 spp (at most 3), depth 6 with roulette from depth 3:

  * the port's wavefront equals the port's megakernel bit for bit on the
    CPU (the same per-path estimates; two samples from a zero sum add the
    same in either order), with the default pool, a pool smaller than the
    image, across progressive steps, with the clamp, on ``glass_demo``
    (the medium in the pool) and on ``textured_demo`` with mips (the cone);
  * it matches the JAX wavefront on the CPU (``traversal="cluster_jax"``)
    within the render tolerance of tests/test_torch_render.py, measured
    here: largest per-pixel difference 3.6e-4 (cornell_bsdf, with NEE),
    no pixel above 1e-3, means equal to 1e-6;
  * ``count_segments`` equals the JAX count (exact below 2^24) and the
    megakernel's ``stats`` for the same render.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.models import progressive as jprog
from pathtracing_tpu.models import scenes as jscenes
from pathtracing_tpu.models import shading as jshading
from pathtracing_tpu.models import wavefront as jwave
from pathtracing_tpu.ops import bvh_native
from pathtracing_tpu.ops import texture as jtex
from pathtracing_tpu.ops.camera import build_camera as jcamera
from pathtracing_tpu.utils.config import RenderConfig as JConfig
from pathtracing_tpu_torch.models import progressive as tprog
from pathtracing_tpu_torch.models import scenes as tscenes
from pathtracing_tpu_torch.models import shading as tshading
from pathtracing_tpu_torch.models import wavefront as twave
from pathtracing_tpu_torch.ops import texture as ttex
from pathtracing_tpu_torch.ops.camera import build_camera as tcamera
from pathtracing_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(2)

SIZE = 24
KW = dict(width=SIZE, height=SIZE, samples_per_pixel=2, samples_per_step=2,
          max_depth=6, rr_start_depth=3, seed=1, nee=True)


def _scene(name, mips=False):
    """(JAX scene, port scene, camera config), both built in numpy."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bvh_native, "build", lambda *a, **k: None)
        if name == "cornell_mesh":
            sj, cc = jscenes.cornell_mesh(3)
            st, _ = tscenes.cornell_mesh(3, device="cpu")
        else:
            sj, cc = jscenes.get_scene(name)
            st, _ = tscenes.get_scene(name, device="cpu")
    if mips:
        sj = sj._replace(textures=jtex.add_mips(sj.textures))
        st = st._replace(textures=ttex.add_mips(st.textures))
    return sj, st, cc


def _port_render(scene, cc, cfg, engine, steps=1, stats=None):
    cam = tcamera(cc, 1.0, device="cpu")
    step = twave.render_step if engine == "wavefront" else tprog.render_step
    state = tprog.init_state(cfg, device="cpu")
    for _ in range(steps):
        state = step(state, scene, cam, cfg, stats=stats)
    return tprog.resolve(state).numpy()


def _jax_wavefront(scene, cc, cfg):
    state = jprog.init_state(cfg)
    state = jwave.render_step(state, scene, jcamera(cc, 1.0), cfg)
    return np.asarray(jprog.resolve(state))


def _assert_render_close(img_j, img_t):
    diff = np.abs(img_j - img_t).max(axis=-1)
    assert (diff > 1e-3).mean() <= 0.01
    assert abs(img_t.mean() - img_j.mean()) <= 0.01 * img_j.mean()


@pytest.mark.parametrize("sampler", ["ld", "independent"])
def test_bounce_with_mixed_depth_matches_jax(sampler):
    """Per-lane depths 0-9 with roulette from 3: the first-vertex LD
    selects and the roulette mask per lane, against the JAX bounce."""
    sj, st, cc = _scene("cornell_bsdf")
    cam_t = tcamera(cc, 1.0, device="cpu")
    n = SIZE * SIZE
    cfg = TConfig(width=SIZE, height=SIZE, sampler=sampler)
    pix = torch.arange(n, dtype=torch.int64)
    keys, o, d = tshading.camera_sample(cam_t, cfg, 3, pix, 1)
    keys_j = jax.random.wrap_key_data(
        jnp.asarray(keys.numpy().astype(np.uint32)))
    rs = np.random.RandomState(5)
    depth = rs.randint(0, 10, n)
    tp = (rs.rand(n, 3) * 0.9 + 0.05).astype(np.float32)
    prev_pdf = (rs.rand(n) + 0.1).astype(np.float32)
    prev_nee = rs.rand(n) > 0.5
    active = rs.rand(n) > 0.1
    ld_nee = ld_sc = None
    if sampler == "ld":
        ld_nee = rs.rand(n, 3).astype(np.float32)
        ld_sc = rs.rand(n, 2).astype(np.float32)
    out_j = jshading.bounce_batch(
        sj, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), keys_j,
        jnp.asarray(depth.astype(np.int32)), jnp.zeros((n, 3)),
        jnp.asarray(tp), jnp.asarray(active), 3, "black", "cluster_jax",
        nee=True, prev_pdf=jnp.asarray(prev_pdf),
        prev_nee=jnp.asarray(prev_nee), return_shadow_count=True,
        ld_nee=None if ld_nee is None else jnp.asarray(ld_nee),
        ld_scatter=None if ld_sc is None else jnp.asarray(ld_sc))
    out_t = tshading.bounce_batch(
        st, o, d, keys, torch.as_tensor(depth), torch.zeros((n, 3)),
        torch.as_tensor(tp), torch.as_tensor(active), 3, "black",
        "cluster_torch", nee=True, prev_pdf=torch.as_tensor(prev_pdf),
        prev_nee=torch.as_tensor(prev_nee), return_shadow_count=True,
        ld_nee=None if ld_nee is None else torch.as_tensor(ld_nee),
        ld_scatter=None if ld_sc is None else torch.as_tensor(ld_sc))
    for i in (4, 6):
        np.testing.assert_array_equal(np.asarray(out_j[i]), out_t[i].numpy())
    assert float(out_j[-1]) == int(out_t[-1])
    for i in (0, 1):
        np.testing.assert_allclose(np.asarray(out_j[i]), out_t[i].numpy(),
                                   atol=1e-5, rtol=1e-5)
    live = out_t[4].numpy()
    np.testing.assert_allclose(np.asarray(out_j[3])[live],
                               out_t[3].numpy()[live], atol=1e-5)
    # Roulette ran on the deep lanes only: some died there, none above.
    rr_dead = active & (depth >= 3) & ~live
    assert rr_dead.any()


@pytest.mark.parametrize("depth", [0, 4])
def test_tensor_depth_equals_int_depth(depth):
    _, st, cc = _scene("cornell_bsdf")
    cam = tcamera(cc, 1.0, device="cpu")
    n = SIZE * SIZE
    cfg = TConfig(width=SIZE, height=SIZE)
    pix = torch.arange(n, dtype=torch.int64)
    keys, o, d = tshading.camera_sample(cam, cfg, 2, pix, 0)
    ld_nee = torch.rand((n, 3), generator=torch.Generator().manual_seed(1))
    ld_sc = torch.rand((n, 2), generator=torch.Generator().manual_seed(2))
    args = (torch.zeros((n, 3)), torch.ones((n, 3)),
            torch.ones(n, dtype=torch.bool), 2, "black", "cluster_torch")
    outs = [tshading.bounce_batch(st, o, d, keys, dp, *args, nee=True,
                                  ld_nee=ld_nee, ld_scatter=ld_sc,
                                  return_shadow_count=True)
            for dp in (depth, torch.full((n,), depth, dtype=torch.int64))]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["cornell_bsdf", "cornell_mesh"])
def test_render_step_matches_jax_and_megakernel(name):
    sj, st, cc = _scene(name)
    img_t = _port_render(st, cc, TConfig(**KW), "wavefront")
    img_m = _port_render(st, cc, TConfig(**KW), "megakernel")
    np.testing.assert_array_equal(img_t, img_m)
    img_j = _jax_wavefront(sj, cc, JConfig(traversal="cluster_jax", **KW))
    _assert_render_close(img_j, img_t)
    assert img_t.mean() > 0.05


def test_pool_smaller_than_the_image_gives_the_same_image():
    _, st, cc = _scene("cornell_bsdf")
    full = _port_render(st, cc, TConfig(**KW), "wavefront")
    stats = {}
    small = _port_render(st, cc, TConfig(wavefront_pool=97, **KW),
                         "wavefront", stats=stats)
    np.testing.assert_array_equal(full, small)
    assert stats["slots"] == 97 * stats["iterations"]
    assert stats["iterations"] > 2 * SIZE * SIZE * 2 // 97


def test_progressive_steps_continue_the_stream():
    sj, st, cc = _scene("cornell_bsdf")
    one = dataclasses.replace(TConfig(**KW), samples_per_step=1)
    two_steps = _port_render(st, cc, one, "wavefront", steps=2)
    np.testing.assert_array_equal(
        two_steps, _port_render(st, cc, TConfig(**KW), "wavefront"))
    jcfg = JConfig(traversal="cluster_jax",
                   **{**KW, "samples_per_step": 1})
    state = jprog.init_state(jcfg)
    for _ in range(2):
        state = jwave.render_step(state, sj, jcamera(cc, 1.0), jcfg)
    _assert_render_close(np.asarray(jprog.resolve(state)), two_steps)


@pytest.mark.parametrize("name", ["cornell_bsdf", "fog_demo"])
def test_count_segments_matches_jax_and_megakernel_stats(name):
    sj, st, cc = _scene(name)
    cfg = TConfig(**KW)
    n_t = twave.count_segments(st, tcamera(cc, 1.0, device="cpu"), cfg, 1)
    n_j = jwave.count_segments(sj, jcamera(cc, 1.0),
                               JConfig(traversal="cluster_jax", **KW), 1)
    assert n_t == int(n_j)
    stats = {}
    _port_render(st, cc, cfg, "megakernel", stats=stats)
    assert n_t == int(stats["segments"]) + int(stats["shadow_segments"])
    stats_w = {}
    _port_render(st, cc, cfg, "wavefront", stats=stats_w)
    assert stats_w["segments"] == int(stats["segments"])
    assert stats_w["shadow_segments"] == int(stats["shadow_segments"])


def test_clamp():
    sj, st, cc = _scene("cornell_bsdf")
    kw = {**KW, "clamp": 0.6}
    img_t = _port_render(st, cc, TConfig(**kw), "wavefront")
    np.testing.assert_array_equal(
        img_t, _port_render(st, cc, TConfig(**kw), "megakernel"))
    assert img_t.max() <= 0.6
    assert img_t.max() < _port_render(st, cc, TConfig(**KW),
                                      "wavefront").max()
    _assert_render_close(
        _jax_wavefront(sj, cc, JConfig(traversal="cluster_jax", **kw)),
        img_t)


@pytest.mark.parametrize("name,mips", [("glass_demo", False),
                                       ("textured_demo", True)])
def test_pool_carries_medium_and_cone(name, mips):
    """glass_demo's per-slot medium and mips textured_demo's per-slot cone
    through the pool."""
    sj, st, cc = _scene(name, mips=mips)
    assert (st.mat_absorb is not None) != mips
    kw = {**KW, "background": tscenes.preferred_background(name)}
    img_t = _port_render(st, cc, TConfig(**kw), "wavefront")
    np.testing.assert_array_equal(
        img_t, _port_render(st, cc, TConfig(**kw), "megakernel"))
    _assert_render_close(
        _jax_wavefront(sj, cc, JConfig(traversal="cluster_jax", **kw)),
        img_t)
