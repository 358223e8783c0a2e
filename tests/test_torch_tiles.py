"""Port parity: ``utils/tiles.py`` (the JAX package's tests/test_tiles.py).

Exact, on the CPU (cornell_sphere, 16x16, depth 3, seed 11, 4 bands): the
bands rendered one by one equal two progressive steps of 2 spp bit for
bit; a render that loses a band (an injected fault) and re-renders it
equals the uninterrupted one; a resume re-renders only the bands that are
behind; a changed config or band count is refused. The adaptive band
scheduler spends exactly its budget, visits every band at least twice and
does not stay uniform when the budget lets it differentiate. A tiled
checkpoint written by the JAX package loads in the port (same fingerprint
and layout), accumulator bit for bit.

Against the JAX package (``traversal="cluster_jax"``, same config): the
adaptive band scheduler visits the same bands, so the two ``band_spp``
are equal, and the image is within the render tolerance of
tests/test_torch_render.py (at most 1% of pixels over 1e-3, means within
1%).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pathtracing_tpu.models import scenes as jscenes
from pathtracing_tpu.ops.camera import build_camera as jcamera
from pathtracing_tpu.utils import tiles as jtiles
from pathtracing_tpu.utils.config import RenderConfig as JConfig
from pathtracing_tpu_torch.models import progressive, scenes
from pathtracing_tpu_torch.ops.camera import build_camera
from pathtracing_tpu_torch.utils import tiles
from pathtracing_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(2)

KW = dict(width=16, height=16, samples_per_pixel=4, max_depth=3,
          samples_per_step=2, seed=11)
CFG = RenderConfig(**KW)


@pytest.fixture(scope="module")
def setup():
    scene, cam_cfg = scenes.cornell_sphere(device="cpu")
    cam = build_camera(cam_cfg, 1.0, device="cpu")
    # Stepped like the tiled driver (2-sample rounds), so the float sums
    # run in the same order and comparisons are bit for bit.
    ref = progressive.init_state(CFG, device="cpu")
    ref = progressive.render_step(ref, scene, cam, CFG)
    ref = progressive.render_step(ref, scene, cam, CFG)
    return scene, cam, ref.accum


def test_bands_match_full_frame(setup):
    scene, cam, ref = setup
    state = tiles.render_tiled(scene, cam, CFG, n_bands=4)
    assert torch.equal(state.accum, ref)
    assert (state.band_spp == 4).all()
    assert torch.equal(tiles.resolve_tiled(state), ref / 4.0)


def test_fault_injection_recovers_bitwise(setup):
    scene, cam, ref = setup
    seen = []
    state = tiles.render_tiled(
        scene, cam, CFG, n_bands=4, inject_fault_band=2,
        progress=lambda band, spp: seen.append((band, spp)))
    assert torch.equal(state.accum, ref)
    # Band 2 dropped at half the target, re-rendered from 0.
    assert seen == [(0, 2), (1, 2), (2, 2), (3, 2), (2, 2), (0, 4),
                    (1, 4), (2, 4), (3, 4)]


def test_checkpoint_resume_only_rerenders_missing(tmp_path, setup):
    scene, cam, ref = setup
    ckpt = str(tmp_path / "tiled.npz")

    state = tiles.init_tiled(CFG, 4, device="cpu")
    state = tiles.render_band(scene, cam, CFG, state, 0, 2)
    state = tiles.render_band(scene, cam, CFG, state, 0, 2)
    state = tiles.render_band(scene, cam, CFG, state, 1, 2)
    tiles.save(ckpt, state, CFG)

    resumed = tiles.load(ckpt, CFG, 4, device="cpu")
    assert list(resumed.band_spp) == [4, 2, 0, 0]
    seen = []
    done = tiles.render_tiled(scene, cam, CFG, 4, state=resumed,
                              checkpoint_path=ckpt,
                              progress=lambda b, s: seen.append(b))
    assert torch.equal(done.accum, ref)
    assert 0 not in seen
    assert os.path.exists(ckpt)
    assert list(tiles.load(ckpt, CFG, 4, device="cpu").band_spp) == [4] * 4


def test_load_rejects_config_change(tmp_path):
    ckpt = str(tmp_path / "tiled.npz")
    tiles.save(ckpt, tiles.init_tiled(CFG, 4, device="cpu"), CFG)
    other = dataclasses.replace(CFG, seed=99)
    with pytest.raises(ValueError, match="refusing to resume"):
        tiles.load(ckpt, other, 4, device="cpu")
    with pytest.raises(ValueError, match="refusing to resume"):
        tiles.load(ckpt, CFG, 8, device="cpu")


def test_bad_band_count_rejected():
    with pytest.raises(ValueError, match="not divisible"):
        tiles.init_tiled(CFG, 3, device="cpu")


def test_jax_tiled_checkpoint_loads(tmp_path, setup):
    _, _, ref = setup
    path = str(tmp_path / "j.npz")
    band_spp = np.array([4, 2, 0, 4], np.int32)
    jtiles.save(path, jtiles.TiledState(
        accum=ref.numpy(), band_spp=band_spp, seed=np.uint32(11)),
        JConfig(**KW))
    state = tiles.load(path, CFG, 4, device="cpu")
    assert torch.equal(state.accum, ref)
    assert np.array_equal(state.band_spp, band_spp) and state.seed == 11
    # The port's file is the JAX layout: the JAX loader takes it back.
    tiles.save(path, state, CFG)
    back = jtiles.load(path, JConfig(**KW), 4)
    assert np.array_equal(np.asarray(back.accum), ref.numpy())


def test_adaptive_respects_budget_and_minimum(setup):
    scene, cam, _ = setup
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=16,
                       max_depth=3, samples_per_step=2, seed=4)
    st = tiles.render_tiled_adaptive(scene, cam, cfg, 4)
    assert int(st.band_spp.sum()) == 4 * 16
    assert st.band_spp.min() >= 4  # every band explored at least twice
    img = tiles.resolve_tiled(st)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0


def test_adaptive_prefers_noisy_bands(setup):
    """The band with the ceiling light converges differently from the
    floor: with budget to differentiate, the allocation is not uniform."""
    scene, cam, _ = setup
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=32,
                       max_depth=4, samples_per_step=2, seed=1)
    st = tiles.render_tiled_adaptive(scene, cam, cfg, 4)
    assert int(st.band_spp.sum()) == 4 * 32
    assert len(set(map(int, st.band_spp))) > 1, "allocation stayed uniform"


@pytest.mark.parametrize("kw", [
    dict(samples_per_pixel=16, max_depth=3, seed=4),
    dict(samples_per_pixel=32, max_depth=4, seed=1)])
def test_adaptive_matches_jax(setup, kw):
    scene, cam, _ = setup
    kw = dict(width=16, height=16, samples_per_step=2, **kw)
    scene_j, cam_cfg = jscenes.cornell_sphere()
    want = jtiles.render_tiled_adaptive(
        scene_j, jcamera(cam_cfg, 1.0), JConfig(traversal="cluster_jax", **kw),
        4)
    got = tiles.render_tiled_adaptive(scene, cam, RenderConfig(**kw), 4)
    np.testing.assert_array_equal(got.band_spp, np.asarray(want.band_spp))
    img = tiles.resolve_tiled(got).numpy()
    ref = np.asarray(jtiles.resolve_tiled(want))
    assert (np.abs(img - ref).max(axis=-1) > 1e-3).mean() <= 0.01
    assert abs(img.mean() - ref.mean()) <= 0.01 * ref.mean()


def test_init_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tiles.init_tiled(CFG, 4)
