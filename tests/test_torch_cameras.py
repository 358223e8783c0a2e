"""Port parity: cameras and the reference image (ROADMAP queue A item 20).
The same camera configs and film coordinates, from fixed seeds, go through
the JAX package (eagerly on the CPU) and the port.

* ``build_camera`` equals the JAX frame bit for bit for the four
  projections (vectors, ``lens_radius``, ``half_fov``, ``aspect``).
* ``generate_ray``: pinhole (with a lens), ortho and equirect rays agree
  with the JAX ones within 2e-7, fisheye within 4e-7: sin, cos, atan2 and
  sqrt of XLA and torch differ by an ulp on some inputs. Measured maxima
  over 5,000 rays: 1.2e-7 pinhole (origins and directions), 0 ortho,
  1.8e-7 fisheye, 1.2e-7 equirect.
* ``lerp`` at per-ray times equals the vmapped JAX ``lerp`` bit for bit,
  and ``resolve`` collapses a pair at mid-shutter.
* ``camera_sample`` with a motion pair traces through the pose at the
  path's ``STREAM_TIME`` draw (plain and LD samplers), the same time the
  megakernel hands to object motion; its rays agree with the vmapped JAX
  ``camera_sample`` within 1e-6, as ``tests/test_torch_shading.py`` holds
  the static camera (measured 1.2e-7 LD, 0 plain).
* A render through each non-pinhole projection and one with a moving
  camera over a scene with moving instances agrees with the JAX CPU render
  at 16x16, 2 spp (the tolerance of ``tests/test_torch_render.py``;
  measured: largest per-pixel difference 3.0e-5 fisheye, 5.5e-6 ortho,
  6.6e-7 equirect, 2.4e-7 motion, no pixel over 1e-3).
* ``render_reference`` equals the JAX image bit for bit, the
  hard-coded-1080 quirk included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.models import progressive as jprog
from pathtracing_tpu.models import reference as jreference
from pathtracing_tpu.models import scenes as jscenes
from pathtracing_tpu.models import shading as jshading
from pathtracing_tpu.ops import camera as jcam
from pathtracing_tpu.utils.config import CameraConfig as JCameraConfig
from pathtracing_tpu.utils.config import RenderConfig as JConfig
from pathtracing_tpu_torch.models import megakernel as tmega
from pathtracing_tpu_torch.models import progressive as tprog
from pathtracing_tpu_torch.models import reference as treference
from pathtracing_tpu_torch.models import scenes as tscenes
from pathtracing_tpu_torch.models import shading as tshading
from pathtracing_tpu_torch.ops import camera as tcam
from pathtracing_tpu_torch.utils.config import CameraConfig
from pathtracing_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(2)

BASE = dict(position=(0.3, 1.1, 3.4), look_at=(0.0, 0.2, 0.0),
            vfov_degrees=47.0, aperture=0.08, focus_distance=3.1)
MOTION = dict(motion_position=(0.6, 1.3, 3.0), motion_look_at=(0.1, 0.2, 0.0))
RAY_TOL = {"pinhole": 2e-7, "ortho": 2e-7, "fisheye": 4e-7,
           "equirect": 2e-7}


def _configs(projection, motion=False):
    kw = dict(BASE, projection=projection, **(MOTION if motion else {}))
    return JCameraConfig(**kw), CameraConfig(**kw)


def _film(n, seed):
    rs = np.random.RandomState(seed)
    return [rs.rand(n).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("projection", tcam.PROJECTIONS)
def test_build_camera_matches_jax(projection):
    cj, ct = _configs(projection)
    a = jcam.build_camera(cj, 16 / 9)
    b = tcam.build_camera(ct, 16 / 9, device="cpu")
    assert b.projection == a.projection == projection
    for f in ("origin", "lower_left", "horizontal", "vertical", "u", "v",
              "w"):
        assert np.asarray(getattr(a, f)).tobytes() == getattr(
            b, f).numpy().tobytes(), f
    for f in ("lens_radius", "half_fov", "aspect"):
        assert np.float32(getattr(a, f)) == np.float32(getattr(b, f)), f
    with pytest.raises(ValueError, match="projection"):
        tcam.build_camera(dataclasses.replace(ct, projection="cylinder"),
                          1.0, device="cpu")


@pytest.mark.parametrize("projection", tcam.PROJECTIONS)
def test_generate_ray_matches_jax(projection):
    cj, ct = _configs(projection)
    a = jcam.build_camera(cj, 16 / 9)
    b = tcam.build_camera(ct, 16 / 9, device="cpu")
    s, t, l1, l2 = _film(5000, 3)
    s[:3], t[:3] = 0.5, 0.5          # the fisheye's center ray
    oj, dj = jcam.generate_ray(a, *(jnp.asarray(x) for x in (s, t, l1, l2)))
    ot, dt = tcam.generate_ray(b, *(torch.as_tensor(x)
                                    for x in (s, t, l1, l2)))
    assert tuple(ot.shape) == tuple(dt.shape) == (5000, 3)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=2e-7,
                               rtol=0)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj),
                               atol=RAY_TOL[projection], rtol=0)
    np.testing.assert_allclose(np.linalg.norm(dt.numpy(), axis=1), 1.0,
                               atol=1e-6)


def test_lerp_and_resolve_match_jax():
    cj, ct = _configs("pinhole", motion=True)
    pj = [jcam.build_camera(c, 1.5) for c in cj.motion_pair()]
    pt = [tcam.build_camera(c, 1.5, device="cpu") for c in ct.motion_pair()]
    assert ct.motion_pair()[1].position == MOTION["motion_position"]
    assert CameraConfig(**BASE).motion_pair() is None
    times = np.random.RandomState(0).rand(257).astype(np.float32)
    lj = jax.vmap(lambda tm: jcam.lerp(pj[0], pj[1], tm))(jnp.asarray(times))
    lt = tcam.lerp(pt[0], pt[1], torch.as_tensor(times))
    for f in ("origin", "lower_left", "horizontal", "vertical"):
        assert np.asarray(getattr(lj, f)).tobytes() == getattr(
            lt, f).numpy().tobytes(), f
    for f in ("u", "v", "w"):
        assert np.asarray(getattr(lj, f)).tobytes() == getattr(
            lt, f).numpy().tobytes(), f
    # Scalars both poses share stay scalars.
    assert lt.lens_radius == pt[0].lens_radius
    mid_j = jcam.resolve(tuple(pj))
    mid_t = tcam.resolve(tuple(pt))
    np.testing.assert_allclose(mid_t.origin.numpy(), np.asarray(mid_j.origin),
                               atol=0, rtol=0)
    assert tcam.resolve(pt[0]) is pt[0]
    with pytest.raises(ValueError, match="projection"):
        tcam.lerp(pt[0], dataclasses.replace(pt[1], projection="ortho"), 0.5)


@pytest.mark.parametrize("sampler", ["ld", "independent"])
def test_camera_sample_with_a_motion_pair_matches_jax(sampler):
    """The moving camera's shutter time is the STREAM_TIME draw that object
    motion takes too: the pose it traces through is the pair lerped at
    ``megakernel.shutter_times``."""
    cj, ct = _configs("pinhole", motion=True)
    pj = tuple(jcam.build_camera(c, 1.0) for c in cj.motion_pair())
    pt = tuple(tcam.build_camera(c, 1.0, device="cpu")
               for c in ct.motion_pair())
    jc = JConfig(width=32, height=24, sampler=sampler)
    tc = TConfig(width=32, height=24, sampler=sampler)
    pix = np.arange(0, 768, 3, dtype=np.int32)
    kj, oj, dj = jax.vmap(lambda p: jshading.camera_sample(
        pj, jc, jnp.uint32(7), p, jnp.int32(2)))(jnp.asarray(pix))
    tpix = torch.as_tensor(pix, dtype=torch.int64)
    kt, ot, dt = tshading.camera_sample(pt, tc, 7, tpix, 2)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(kj)).astype(np.int64), kt.numpy())
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)
    times = tmega.shutter_times(tc, 7, tpix, 2, kt)
    posed = tcam.lerp(pt[0], pt[1], times)
    _, o2, d2 = tshading.camera_sample(posed, tc, 7, tpix, 2)
    assert torch.equal(o2, ot) and torch.equal(d2, dt)
    still = tshading.camera_sample(pt[0], tc, 7, tpix, 2)[2]
    assert not torch.equal(still, dt)


def _moving_instances(builder_cls):
    """A ground, a light and a 2x2 field of instanced icospheres, each with
    a shutter-close transform (object motion)."""
    b = builder_cls()
    ground = b.lambertian((0.6, 0.6, 0.55))
    b.add_quad((-4.0, 0.0, -4.0), (8.0, 0.0, 0.0), (0.0, 0.0, 8.0), ground)
    light = b.emissive((20.0, 20.0, 20.0))
    b.add_quad((-1.0, 5.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), light)
    verts, faces = tscenes.icosphere(1, 0.5)
    ts, closes = [], []
    for i in range(2):
        for j in range(2):
            m = np.concatenate([np.eye(3), [[i - 0.5], [0.5], [j - 0.5]]],
                               axis=1)
            ts.append(m)
            closes.append(m + np.array([[0, 0, 0, 0.3], [0, 0, 0, 0.1],
                                        [0, 0, 0, 0.0]]))
    b.add_instances(verts, faces, b.lambertian((0.7, 0.3, 0.2)), ts,
                    motion_transforms=closes)
    return b


RENDERS = ["ortho", "fisheye", "equirect", "motion"]


@pytest.mark.parametrize("case", RENDERS)
def test_render_through_each_camera_matches_jax(case):
    from pathtracing_tpu.models.scene import SceneBuilder as JBuilder

    kw = dict(width=16, height=16, samples_per_pixel=2, max_depth=3,
              seed=2, nee=True)
    if case == "motion":
        sj = _moving_instances(JBuilder).build()
        st = _moving_instances(tscenes.SceneBuilder).build("cpu")
        ccj, cct = (dataclasses.replace(c, position=(0.0, 2.5, 5.0),
                                        look_at=(0.0, 0.5, 0.0),
                                        motion_position=(0.8, 2.7, 4.6),
                                        aperture=0.0)
                    for c in _configs("pinhole"))
        cam_j = tuple(jcam.build_camera(c, 1.0) for c in ccj.motion_pair())
        cam_t = tuple(tcam.build_camera(c, 1.0, device="cpu")
                      for c in cct.motion_pair())
        trav_j = "cluster_jax"
    else:
        sj, cc = jscenes.cornell_sphere()
        st, _ = tscenes.cornell_sphere(device="cpu")
        cc = dataclasses.replace(cc, projection=case)
        cct = CameraConfig(**dataclasses.asdict(cc))
        cam_j = jcam.build_camera(cc, 1.0)
        cam_t = tcam.build_camera(cct, 1.0, device="cpu")
        trav_j = "cluster_jax"
    img_j = np.asarray(jprog.render_once(sj, cam_j,
                                         JConfig(traversal=trav_j, **kw)))
    img_t = tprog.render_once(st, cam_t, TConfig(**kw)).numpy()
    assert np.isfinite(img_t).all() and img_t.mean() > 0.01
    diff = np.abs(img_j - img_t).max(axis=-1)
    assert (diff > 1e-3).mean() <= 0.01
    assert abs(img_t.mean() - img_j.mean()) <= 0.01 * img_j.mean()


@pytest.mark.parametrize("shape,resolution", [((36, 64), None),
                                              ((27, 48), (1080, 1080))])
def test_render_reference_matches_jax(shape, resolution):
    h, w = shape
    a = np.asarray(jreference.render_reference(h, w, resolution))
    b = treference.render_reference(h, w, resolution, device="cpu").numpy()
    assert b.shape == (h, w, 4) and b.dtype == np.float32
    assert a.tobytes() == b.tobytes()
    assert (b[..., 3] == 1.0).all()
    # The sphere shows in the middle (with the true resolution; the
    # hard-coded 1080 stretches it off a small image), the (uv, 0) miss
    # color at a corner.
    if resolution is None:
        assert b[h // 2, w // 2, 2] > 0.9
    np.testing.assert_allclose(b[0, 0, :3], a[0, 0, :3], atol=0)


def test_reference_ray_matches_jax():
    xs = np.arange(0, 1920, 37, dtype=np.float32)
    ys = np.arange(0, 1080, 23, dtype=np.float32)[:xs.shape[0]]
    xs = xs[:ys.shape[0]]
    a = jcam.reference_ray(jnp.asarray(xs), jnp.asarray(ys), 1920.0, 1080.0)
    b = tcam.reference_ray(torch.as_tensor(xs), torch.as_tensor(ys), 1920.0,
                           1080.0)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1.2e-7,
                                   rtol=0)
    assert tuple(b[0].shape) == (xs.shape[0], 3)
