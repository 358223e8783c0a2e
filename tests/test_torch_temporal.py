"""Port parity: temporal reuse (``models/temporal.py``) and the camera's
``project`` and ``cam_depth``.

  * ``project`` inverts ``generate_ray`` for the lens-centre ray on every
    projection (within 2e-4 of the film coordinates, the tolerance of
    tests/test_temporal.py);
  * ``project`` and ``cam_depth`` agree with the JAX package's on the same
    random points, in front of and behind the camera: the validity masks
    equal, (s, t) within 2e-6 and depth within 1e-6 relative (measured
    here: pinhole and ortho equal, fisheye and equirect at most 5.1e-7
    for (s, t) and 1.2e-7 relative for depth; XLA's and torch's acos and
    atan2 differ by an ulp on some inputs);
  * ``features`` on cornell_bsdf (mirror and glass spheres, a light) at
    16x16: on all but ``EDGE_FRACTION`` of the pixels validity, material,
    specular mask and emitter band equal JAX's, and positions, depths and
    normals agree within 2e-5 (measured 3.5e-6, 3.6e-6 and 9.0e-6: a
    sphere's normal follows its hit point). The other pixels' centre
    rays pass through an edge or corner of the box, where XLA:CPU's fused
    multiply-adds (ROADMAP caveat C8) may pick the other triangle or miss:
    6 of 256 pixels (2.3%);
  * a 3-frame orbit through ``advance`` from the same numpy frames: the
    history lengths within 1e-5 on every pixel, the images within 1e-5 on all
    but ``EDGE_FRACTION`` of the pixels (measured: 4 and 6 of 256 pixels
    differ, those edge pixels; elsewhere at most 2.4e-6);
  * with a static camera the blend is the running mean of the frames, and
    a teleported camera restarts the history.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.models import scenes as jscenes
from pathtracing_tpu.models import temporal as jtemporal
from pathtracing_tpu.ops import camera as jcam_ops
from pathtracing_tpu.utils.config import CameraConfig as JCameraConfig
from pathtracing_tpu.utils.config import RenderConfig as JConfig
from pathtracing_tpu_torch.models import scenes as tscenes
from pathtracing_tpu_torch.models import temporal as ttemporal
from pathtracing_tpu_torch.ops import camera as tcam_ops
from pathtracing_tpu_torch.utils.config import CameraConfig as TCameraConfig
from pathtracing_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(2)

SIZE = 16
KW = dict(width=SIZE, height=SIZE, samples_per_pixel=1, max_depth=2,
          seed=0, background="black")
CFG = TConfig(**KW)
JCFG = JConfig(traversal="cluster_jax", **KW)
# The share of pixels allowed to differ from the JAX package's features
# and blends: centre rays through an edge or corner of the box (measured
# at 16x16: at most 6 of 256 pixels, 2.3%).
EDGE_FRACTION = 0.03
CAM_KW = dict(position=(1.0, 2.0, 3.0), look_at=(0.0, 0.5, 0.0),
              vfov_degrees=55.0)


def _cams(proj):
    return (jcam_ops.build_camera(JCameraConfig(projection=proj, **CAM_KW),
                                  1.5),
            tcam_ops.build_camera(TCameraConfig(projection=proj, **CAM_KW),
                                  1.5, device="cpu"))


@pytest.mark.parametrize("proj", tcam_ops.PROJECTIONS)
def test_project_inverts_generate_ray(proj):
    rs = np.random.RandomState(0)
    _, cam = _cams(proj)
    # Away from the film edges (the angular projections fold there).
    s = torch.as_tensor((rs.rand(128) * 0.8 + 0.1).astype(np.float32))
    t = torch.as_tensor((rs.rand(128) * 0.8 + 0.1).astype(np.float32))
    zeros = torch.zeros_like(s)
    o, d = tcam_ops.generate_ray(cam, s, t, zeros, zeros)
    p = o + d * torch.as_tensor((rs.rand(128, 1) * 4 + 0.5).astype(
        np.float32))
    s2, t2, ok = tcam_ops.project(cam, p)
    assert float(ok.float().mean()) > 0.95
    np.testing.assert_allclose(s2[ok].numpy(), s[ok].numpy(), atol=2e-4)
    np.testing.assert_allclose(t2[ok].numpy(), t[ok].numpy(), atol=2e-4)


@pytest.mark.parametrize("proj", tcam_ops.PROJECTIONS)
def test_project_and_cam_depth_match_jax(proj):
    rs = np.random.RandomState(1)
    jcam, tcam = _cams(proj)
    p = (rs.randn(500, 3) * 3).astype(np.float32)
    sj, tj, vj = jcam_ops.project(jcam, jnp.asarray(p))
    st, tt, vt = tcam_ops.project(tcam, torch.as_tensor(p))
    assert np.array_equal(np.asarray(vj), vt.numpy())
    assert 0.2 < vt.float().mean() <= 1.0
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(
        tcam_ops.cam_depth(tcam, torch.as_tensor(p)).numpy(),
        np.asarray(jcam_ops.cam_depth(jcam, jnp.asarray(p))), rtol=1e-6)


@pytest.fixture(scope="module")
def bsdf():
    scene_j, cam_cfg = jscenes.get_scene("cornell_bsdf")
    scene_t, _ = tscenes.get_scene("cornell_bsdf", device="cpu")
    return scene_j, scene_t, cam_cfg


def _orbit(cam_cfg, i, arc=np.radians(6.0)):
    """The pose ``i`` frames along a small orbit about the look-at point."""
    base = np.asarray(cam_cfg.position, np.float32)
    target = np.asarray(cam_cfg.look_at, np.float32)
    rel = base - target
    r_xz = float(np.hypot(rel[0], rel[2]))
    phi = float(np.arctan2(rel[0], rel[2])) + arc * i
    pos = target + np.array([r_xz * np.sin(phi), rel[1],
                             r_xz * np.cos(phi)], np.float32)
    return dataclasses.replace(cam_cfg, position=tuple(map(float, pos)))


def _both_cams(cam_cfg):
    return (jcam_ops.build_camera(cam_cfg, 1.0),
            tcam_ops.build_camera(cam_cfg, 1.0, device="cpu"))


def test_features_match_jax(bsdf):
    scene_j, scene_t, cam_cfg = bsdf
    jcam, tcam = _both_cams(cam_cfg)
    fj = [np.asarray(a) for a in jtemporal.features(scene_j, jcam, JCFG)]
    ft = [b.numpy() for b in ttemporal.features(scene_t, tcam, CFG)]
    # Pixels whose centre ray meets an edge or corner of the box: XLA:CPU
    # fuses the Woop test's multiply-adds (ROADMAP caveat C8), so a ray
    # through an edge may hit the other triangle, or miss, there.
    edge = ((fj[3] != ft[3]) | (fj[6] != ft[6])
            | (np.abs(fj[2] - ft[2]).max(-1) > 2e-5))
    assert edge.mean() <= EDGE_FRACTION
    names = ("pos", "depth", "normal", "valid", "spec", "emis_band", "mat")
    for name, a, b in zip(names, fj, ft):
        assert a.shape == b.shape, name
        if a.dtype.kind in "bi":
            assert np.array_equal(a[~edge], b[~edge]), name
        else:
            np.testing.assert_allclose(b[~edge], a[~edge], rtol=0,
                                       atol=2e-5, err_msg=name)
    valid, spec, band = ft[3], ft[4], ft[5]
    assert valid.mean() > 0.9 and spec.any() and band.any()


def test_orbit_advance_matches_jax(bsdf):
    scene_j, scene_t, cam_cfg = bsdf
    rs = np.random.RandomState(5)
    sj = jtemporal.init_state(JCFG)
    st = ttemporal.init_state(CFG, device="cpu")
    prev = None
    accepted = []
    for i in range(3):
        jcam, tcam = _both_cams(_orbit(cam_cfg, i))
        jprev, tprev = (jcam, tcam) if prev is None else prev
        frame = (rs.rand(SIZE, SIZE, 3) * 2).astype(np.float32)
        out_j, sj = jtemporal.advance(sj, jnp.asarray(frame), scene_j, jcam,
                                      jprev, JCFG)
        out_t, st = ttemporal.advance(st, torch.as_tensor(frame), scene_t,
                                      tcam, tprev, CFG)
        diff = np.abs(out_t.numpy() - np.asarray(out_j)).max(-1)
        len_j, len_t = np.asarray(sj.hist_len), st.hist_len.numpy()
        assert (diff > 1e-5).mean() <= EDGE_FRACTION
        np.testing.assert_allclose(len_t, len_j, rtol=0, atol=1e-5)
        accepted.append(float((len_t > 1.0).mean()))
        prev = (jcam, tcam)
    # Frames 2 and 3 reuse history on most of the image.
    assert accepted[0] == 0.0 and min(accepted[1:]) > 0.5


def test_static_camera_blend_is_running_mean(bsdf):
    _, scene_t, cam_cfg = bsdf
    cam = tcam_ops.build_camera(cam_cfg, 1.0, device="cpu")
    rs = np.random.RandomState(2)
    state = ttemporal.init_state(CFG, device="cpu")
    frames = []
    for _ in range(3):
        frames.append(torch.as_tensor(
            rs.rand(SIZE, SIZE, 3).astype(np.float32)))
        out, state = ttemporal.advance(state, frames[-1], scene_t, cam, cam,
                                       CFG)
    _, _, _, valid, spec, band, _ = ttemporal.features(scene_t, cam, CFG)
    keep = valid & ~spec & ~band
    want = torch.stack(frames).mean(0)
    np.testing.assert_allclose(out[keep].numpy(), want[keep].numpy(),
                               atol=1e-6)
    assert float(state.hist_len[keep].max()) == 3.0
    assert float(state.hist_len[spec].max()) == 3.0   # spec_cap


def test_teleported_camera_restarts_history(bsdf):
    _, scene_t, cam_cfg = bsdf
    pos = np.asarray(cam_cfg.position)
    look = np.asarray(cam_cfg.look_at)
    cam_a = tcam_ops.build_camera(cam_cfg, 1.0, device="cpu")
    cam_b = tcam_ops.build_camera(dataclasses.replace(
        cam_cfg, position=tuple(map(float, look + (look - pos)))), 1.0,
        device="cpu")
    state = ttemporal.init_state(CFG, device="cpu")
    _, state = ttemporal.advance(state, torch.ones(SIZE, SIZE, 3), scene_t,
                                 cam_a, cam_a, CFG)
    cur = torch.full((SIZE, SIZE, 3), 0.25)
    out, state = ttemporal.advance(state, cur, scene_t, cam_b, cam_a, CFG)
    restart = state.hist_len <= 1.0
    assert float(restart.float().mean()) > 0.95
    assert torch.equal(out[restart], cur[restart])


def test_temporal_state_takes_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttemporal.init_state(CFG)
    state = ttemporal.init_state(CFG, device="cpu")
    assert state.mat.dtype == torch.int32 and int(state.mat.max()) == -1
