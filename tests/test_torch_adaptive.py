"""Port parity: the megakernel's scattered modes and the adaptive
schedulers (``models/adaptive.py``).

Exact (bit for bit, on the CPU):

  * the rows and pixels modes give block mode's samples of the same
    (pixel, sample) ids, chunked and padded at a small MAX_WAVE_RAYS too,
    with the clamp, and ``sample_stride`` gives the samples it names;
  * band and tile schedules that pick every unit (``spp_per_round`` 1 and
    2), and ``uniform_tile_rounds``, give ``progressive.render_step``'s
    image;
  * the picks follow ``jax.lax.top_k``'s order on constructed ties (every
    unit unexplored scores 3e38 - spp in float32, so spp 0 and 1 tie).

Against the JAX package (``traversal="cluster_jax"``), cornell_sphere at
16x16, depth 3, seed 11, a 4 spp budget (8 with ``target_rmse``):
``render_adaptive`` and ``render_adaptive_tiles`` (greedy,
``auto_uniform``, ``target_rmse``) give the same spp maps, rounds and
spent budget after every dispatch group (``progress``), and images within
the render tolerance of tests/test_torch_render.py (at most 1% of pixels
over 1e-3, means within 1%). Measured here: the spp maps, rounds and
spent budgets equal in every case (the scores sum in other orders, so a
near-tie could flip a pick; none did); largest image difference 4.6e-6
(bands; 2.1e-6 to 3.9e-6 for tiles), means equal to 1e-7. The scores, ``predicted_rmse`` and the
Neyman bound of one random state agree with JAX's within 1e-6 relative
(float32 sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.models import adaptive as jad
from pathtracing_tpu.models import scenes as jscenes
from pathtracing_tpu.ops.camera import build_camera as jcamera
from pathtracing_tpu.utils.config import RenderConfig as JConfig
from pathtracing_tpu_torch.models import adaptive as tad
from pathtracing_tpu_torch.models import megakernel, progressive
from pathtracing_tpu_torch.models import scenes as tscenes
from pathtracing_tpu_torch.ops.camera import build_camera as tcamera
from pathtracing_tpu_torch.utils import config as tconfig
from pathtracing_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(2)

KW = dict(width=16, height=16, samples_per_pixel=4, max_depth=3, seed=11,
          samples_per_step=1)
CFG = TConfig(**KW)
JCFG = JConfig(traversal="cluster_jax", **KW)


@pytest.fixture(scope="module")
def setup():
    scene_j, cam_cfg = jscenes.cornell_sphere()
    scene_t, _ = tscenes.cornell_sphere(device="cpu")
    return (scene_j, jcamera(cam_cfg, 1.0), scene_t,
            tcamera(cam_cfg, 1.0, device="cpu"))


def _block(scene, cam, cfg, sample, stats=None):
    return megakernel.render_samples(scene, cam, cfg, sample, 1, cfg.seed,
                                     stats=stats)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("clamp", [0.0, 0.5])
def test_rows_mode_equals_block_mode(setup, monkeypatch, chunked, clamp):
    _, _, scene, cam = setup
    cfg = dataclasses.replace(CFG, clamp=clamp)
    blocks = {s: _block(scene, cam, cfg, s) for s in (0, 2, 5)}
    if chunked:
        # 3 rows a wave: 7 rows make 3 chunks, the last padded by 2.
        monkeypatch.setattr(megakernel, "MAX_WAVE_RAYS", 48)
    rows = torch.tensor([5, 0, 15, 7, 8, 2, 11])
    start = torch.tensor([2, 0, 5, 2, 0, 5, 2])
    got = megakernel.render_samples(scene, cam, cfg, 0, 1, cfg.seed,
                                    rows=rows, rows_sample_start=start)
    assert got.shape == (7, 16, 3)
    want = torch.stack([blocks[int(s)][int(r)] for r, s in zip(rows, start)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("chunked", [False, True])
def test_pixels_mode_equals_block_mode(setup, monkeypatch, chunked):
    _, _, scene, cam = setup
    gen = torch.Generator().manual_seed(0)
    pix = torch.randperm(256, generator=gen)[:101]
    start = torch.randint(0, 3, (101,), generator=gen)
    blocks = {s: _block(scene, cam, CFG, s).reshape(-1, 3) for s in range(3)}
    if chunked:
        # 101 pixels (prime): 3 waves of 48, the last padded by 43.
        monkeypatch.setattr(megakernel, "MAX_WAVE_RAYS", 48)
    got = megakernel.render_samples(scene, cam, CFG, 0, 2, CFG.seed,
                                    pixels=pix, pixels_sample_start=start,
                                    sample_stride=1)
    assert got.shape == (101, 3)
    # Two samples from each pixel's own counter, summed in sample order.
    want = torch.stack([
        blocks[int(s)][int(p)] for p, s in zip(pix, start)])
    more = {s: _block(scene, cam, CFG, s + 1).reshape(-1, 3)
            for s in range(3)}
    want = want + torch.stack([more[int(s)][int(p)]
                               for p, s in zip(pix, start)])
    assert torch.equal(got, want)


def test_rows_mode_counts_segments_as_block_mode(setup):
    _, _, scene, cam = setup
    st_block, st_rows = {}, {}
    img = _block(scene, cam, CFG, 3, stats=st_block)
    rows = megakernel.render_samples(
        scene, cam, CFG, 0, 1, CFG.seed, rows=torch.arange(16),
        rows_sample_start=torch.full((16,), 3), stats=st_rows)
    assert torch.equal(img, rows)
    for k in ("segments", "shadow_segments"):
        assert int(st_block[k]) == int(st_rows[k]) > 0


def test_sample_stride_names_its_samples(setup):
    _, _, scene, cam = setup
    got = megakernel.render_samples(scene, cam, CFG, 1, 3, CFG.seed,
                                    sample_stride=2)
    want = torch.zeros_like(got)
    for s in (1, 3, 5):
        want = want + _block(scene, cam, CFG, s)
    assert torch.equal(got, want)
    # A 0-d tensor counter (uniform_tile_rounds passes one).
    assert torch.equal(
        megakernel.render_samples(scene, cam, CFG, torch.tensor(3), 1,
                                  CFG.seed), _block(scene, cam, CFG, 3))


def test_scattered_modes_need_their_counters(setup):
    _, _, scene, cam = setup
    with pytest.raises(ValueError, match="rows_sample_start"):
        megakernel.render_samples(scene, cam, CFG, 0, 1, 0,
                                  rows=torch.arange(2))
    with pytest.raises(ValueError, match="pixels_sample_start"):
        megakernel.render_samples(scene, cam, CFG, 0, 1, 0,
                                  pixels=torch.arange(2))


@pytest.mark.parametrize("scores", [
    np.full(16, 3.0e38, np.float32),                        # all tie
    np.float32(3.0e38) - np.array([0, 1, 2, 1, 0, 3, 0, 1], np.float32),
    np.array([0, 0, 2, 0, 1, 2, 0, 0, 1, 0], np.float32),   # zero variance
])
def test_top_k_follows_jax_tie_order(scores):
    for k in (1, 3, len(scores) // 2):
        _, want = jax.lax.top_k(jnp.asarray(scores), k)
        got = tad.top_k(torch.as_tensor(scores), k)
        assert got.tolist() == np.asarray(want).tolist(), (scores, k)
    # spp 0 and 1 tie at 3e38 in float32: the lower index wins.
    spp = torch.tensor([1, 0, 1, 0], dtype=torch.int32)
    ex = tad._explore(spp, torch.zeros(4))
    assert tad.top_k(ex, 2).tolist() == [0, 1]


def _progressive(scene, cam, steps):
    state = progressive.init_state(CFG, device="cpu")
    for _ in range(steps):
        state = progressive.render_step(state, scene, cam, CFG)
    return state.accum


@pytest.mark.parametrize("spr", [1, 2])
def test_equal_spp_schedules_equal_progressive(setup, spr):
    """Bands of 2 rows and 4x4 tiles, every unit picked each round, and
    uniform_tile_rounds: the progressive engine's sums bit for bit."""
    _, _, scene, cam = setup
    rounds = 4 // spr
    want = _progressive(scene, cam, 4)
    bands = tad.init_state(CFG, 2, device="cpu")
    tiles = tad.init_tile_state(CFG, 4, device="cpu")
    for _ in range(rounds):
        bands = tad.adaptive_step(bands, scene, cam, CFG, 2,
                                  torch.arange(8), spr)
        tiles = tad.tile_step(tiles, scene, cam, CFG, 4,
                              torch.arange(16).flip(0), spr)
    assert torch.equal(bands.accum, want)
    assert bands.band_spp.tolist() == [4] * 8
    untiled = tiles.accum.reshape(4, 4, 4, 4, 3).permute(0, 2, 1, 3, 4)
    assert torch.equal(untiled.reshape(16, 16, 3), want)
    assert tiles.tile_spp.tolist() == [4] * 16
    uni = tad.uniform_tile_rounds(tad.init_tile_state(CFG, 4, device="cpu"),
                                  scene, cam, CFG, 4, 4)
    assert torch.equal(uni.accum, tiles.accum)
    assert torch.equal(uni.m2, tiles.m2)
    assert torch.equal(tad.resolve(bands, 2),
                       tad.resolve_tiles(tiles, CFG, 4))


def _jnp_state(state):
    return type(state)(*(jnp.asarray(np.asarray(a)) for a in state[:3]),
                       jnp.uint32(state.seed))


def test_scores_and_estimates_match_jax():
    rs = np.random.RandomState(3)
    accum = (rs.rand(16, 16, 3) * 4).astype(np.float32)
    m2 = (rs.rand(16, 16) * 20).astype(np.float32)
    spp = rs.randint(0, 6, 8).astype(np.int32)
    band = tad.AdaptiveState(torch.as_tensor(accum), torch.as_tensor(m2),
                             torch.as_tensor(spp), 11)
    np.testing.assert_allclose(
        tad.band_scores(band, CFG, 2).numpy(),
        np.asarray(jad.band_scores(_jnp_state(band), JCFG, 2)), rtol=1e-6)
    tiles = tad.TileState(
        torch.as_tensor(accum.reshape(16, 4, 4, 3)),
        torch.as_tensor((rs.rand(16, 4, 4, 3) * 30).astype(np.float32)),
        torch.as_tensor(rs.randint(0, 6, 16).astype(np.int32)), 11)
    jt = _jnp_state(tiles)
    np.testing.assert_allclose(tad.tile_scores(tiles, CFG, 4).numpy(),
                               np.asarray(jad._tile_scores(jt, JCFG, 4)),
                               rtol=1e-6)
    for fn in ("predicted_rmse", "tile_neyman_gain"):
        assert float(getattr(tad, fn)(tiles, CFG, 4)) == pytest.approx(
            float(getattr(jad, fn)(jt, JCFG, 4)), rel=1e-6)


def _run(module, scene, cam, cfg, mode, **kw):
    """(state, rounds, [(spent, budget) after each dispatch group])."""
    log = []
    fn = (module.render_adaptive if mode == "bands"
          else module.render_adaptive_tiles)
    state, rounds = fn(scene, cam, cfg, progress=lambda s, spent, budget:
                       log.append((spent, budget)), **kw)
    return state, rounds, log


# The tile cases share K = 4 and groups of 4 rounds, so the JAX side
# compiles its tile functions once.
CASES = {
    "bands": ("bands", dict(band_rows=2, budget_spp=4)),
    "tiles": ("tiles", dict(tile=4, budget_spp=4, tiles_per_round=4)),
    "tiles_auto_uniform": ("tiles", dict(tile=4, budget_spp=4,
                                         tiles_per_round=4,
                                         auto_uniform=1e9)),
    "tiles_target_rmse": ("tiles", dict(tile=4, budget_spp=8,
                                        tiles_per_round=4,
                                        target_rmse=0.5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adaptive_renders_match_jax(setup, case):
    mode, kw = CASES[case]
    scene_j, cam_j, scene_t, cam_t = setup
    sj, rj, lj = _run(jad, scene_j, cam_j, JCFG, mode, **kw)
    st, rt, lt = _run(tad, scene_t, cam_t, CFG, mode, **kw)
    spp_j, spp_t = ((sj.band_spp, st.band_spp) if mode == "bands"
                    else (sj.tile_spp, st.tile_spp))
    assert st.accum.device.type == "cpu"
    assert spp_t.tolist() == np.asarray(spp_j).tolist()
    assert rt == rj and lt == lj
    if mode == "bands":
        img_j = np.asarray(jad.resolve(sj, 2))
        img_t = tad.resolve(st, 2).numpy()
    else:
        img_j = np.asarray(jad.resolve_tiles(sj, JCFG, 4))
        img_t = tad.resolve_tiles(st, CFG, 4).numpy()
    diff = np.abs(img_j - img_t).max(axis=-1)
    assert (diff > 1e-3).mean() <= 0.01
    assert abs(img_t.mean() - img_j.mean()) <= 0.01 * img_j.mean()
    if case == "tiles_target_rmse":
        # It stops before the budget, at or under the target.
        assert lt[-1][0] < lt[-1][1]
        assert float(tad.predicted_rmse(st, CFG, 4)) <= 0.5


def test_target_rmse_guard_reports_the_tested_value(setup, monkeypatch):
    """Caveat C6: a warmup below 2 spp disables ``target_rmse``; the
    warning names min(warmup_spp, budget), the value the guard tests."""
    _, _, scene, cam = setup
    said = []
    monkeypatch.setattr(tad.ptlog, "log_warning",
                        lambda msg, *a: said.append(msg % a))
    state, _ = tad.render_adaptive_tiles(scene, cam, CFG, tile=4,
                                         warmup_spp=3, budget_spp=1,
                                         target_rmse=1.0)
    assert len(said) == 1 and "= 1)" in said[0]
    assert int(state.tile_spp.sum()) == 16          # the whole budget


def test_adaptive_entry_points_take_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: tad.init_state(CFG, 2),
               lambda: tad.init_tile_state(CFG, 4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
    assert tconfig.resolve_device("cpu").type == "cpu"
    assert tad.init_tile_state(CFG, 4, device="cpu").accum.shape == (
        16, 4, 4, 3)
