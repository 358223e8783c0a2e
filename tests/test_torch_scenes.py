"""Port parity: the scene registry and the bench entry point.

Every ``Scene`` field of each of the port's 21 registry scenes (all of
the JAX registry's) equals the JAX package's, built from the same builder
calls: the None/non-None pattern of every optional column and table
(``mat_absorb``, ``mat_param2``, ``mat_disp``, ``mat_aniso``,
``mat_metallic``, ``mat_clearcoat``, ``mat_interior``, ``fog``, ``vol``,
``env``, ``delta``, ``instances``, ``pages``, the surface attributes,
``textures`` and the ``mat_*tex`` columns), and every array, bit for bit,
the threaded ``bvh`` and the voxel grid's tables included. Both sides
build the BVH order and the cluster tables in numpy (the JAX side's
native builder is switched off, the port's C++ builder gives the numpy
bytes); the TPU-only ``cand_box`` is dropped. ``PREFERRED_BACKGROUND`` is
the JAX map.

The bench module (``python -m pathtracing_tpu_torch.bench``) exits
non-zero with a message when no CUDA device is present, and resolves
``BENCH_SCENE`` through the registry.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pathtracing_tpu.models import scenes as jscenes
from pathtracing_tpu.ops import bvh_native
from pathtracing_tpu_torch import bench
from pathtracing_tpu_torch.models import scene as tscene_mod
from pathtracing_tpu_torch.models import scenes as tscenes

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED = sorted(tscenes.SCENES)
# Tables compared field by field; the rest of a Scene is arrays.
TABLES = ("clusters", "lights", "instances", "pages", "env", "delta", "bvh",
          "textures", "vol")
# JAX-only table fields the port drops by design (TPU-only layout).
DROPPED = {"cand_box"}
# build() arguments per builder class (the port's takes the device).
BUILD_KW = {tscene_mod.SceneBuilder: {"device": "cpu"}}


@pytest.fixture(scope="module")
def built():
    """{name: (JAX scene, port scene)} of every registry scene."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bvh_native, "build", lambda *a, **k: None)
        for name in PORTED:
            out[name] = (jscenes.SCENES[name]()[0],
                         tscenes.get_scene(name, device="cpu")[0])
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fields_of(x):
    if hasattr(x, "_asdict"):
        return x._asdict()
    if dataclasses.is_dataclass(x):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    return dict(x)


def _assert_arrays_equal(a, b, what):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                        b.dtype, a.shape,
                                                        b.shape)
    assert a.tobytes() == b.tobytes(), what


def test_registry_holds_the_fourteen_scenes():
    """Fourteen scenes until the surface-attribute slice added three; the
    media slice adds the last four, so the registry is the JAX one."""
    assert len(tscenes.SCENES) == 21
    assert set(tscenes.SCENES) == set(jscenes.SCENES)


def test_preferred_background_is_the_jax_map_restricted():
    assert tscenes.PREFERRED_BACKGROUND == jscenes.PREFERRED_BACKGROUND
    for name in PORTED:
        assert (tscenes.preferred_background(name)
                == jscenes.preferred_background(name))


def test_get_scene_refuses_unknown_names():
    with pytest.raises(KeyError):
        tscenes.get_scene("no_such_scene", device="cpu")


@pytest.mark.parametrize("name", PORTED)
def test_scene_fields_equal(built, name):
    scene_j, scene_t = built[name]
    jf = scene_j._asdict()
    for f, b in scene_t._asdict().items():
        # A port-only field (``inst_tree``) reads None on the JAX side,
        # so the port's must be None too.
        a = jf.get(f)
        assert (a is None) == (b is None), (name, f)
        if a is None:
            continue
        if f not in TABLES:
            _assert_arrays_equal(a, b, (name, f))
            continue
        ta, tb = _fields_of(a), _fields_of(b)
        assert set(ta) - set(tb) <= DROPPED, (name, f)
        for g, y in tb.items():
            if g not in ta:
                continue        # port-only derived columns (placement boxes)
            x = ta[g]
            assert (x is None) == (y is None), (name, f, g)
            if x is not None:
                _assert_arrays_equal(x, y, (name, f, g))
    for f in set(jf) - set(scene_t._fields):
        assert jf[f] is None, (name, f)


def test_optional_columns_follow_the_materials(built):
    """The None pattern on the scenes that exercise each column."""
    def has(name, f):
        return getattr(built[name][1], f) is not None
    assert has("glass_demo", "mat_absorb")
    assert not has("glass_demo", "mat_param2")
    assert has("frosted_demo", "mat_absorb") and has("frosted_demo",
                                                     "mat_param2")
    assert has("prism_demo", "mat_disp")
    assert not has("prism_demo", "mat_absorb")
    assert has("spotlight_demo", "mat_aniso") and has("spotlight_demo",
                                                      "delta")
    assert has("envmap_demo", "env") and has("principled_demo", "env")
    for f in ("mat_absorb", "mat_param2", "mat_disp", "mat_aniso", "env",
              "delta"):
        for name in ("cornell_sphere", "cornell_bsdf", "cornell_mesh",
                     "instanced_demo", "many_lights_demo"):
            assert not has(name, f), (name, f)
    # Emitter-free scenes keep the JAX SceneBuilder's empty light table.
    for name in ("sphere_demo", "checker_demo", "envmap_demo",
                 "principled_demo", "spotlight_demo"):
        assert float(built[name][1].lights.total_power) == 0.0


@pytest.mark.parametrize("name", ["glass_demo", "frosted_demo", "prism_demo",
                                  "envmap_demo", "spotlight_demo", "fog_demo",
                                  "smoke_demo", "fire_demo", "sss_demo"])
def test_scene_from_numpy_carries_the_new_fields(built, name):
    scene_j, scene_t = built[name]
    s = tscene_mod.scene_from_numpy(jax.tree.map(np.asarray, scene_j), "cpu")
    for f in ("mat_absorb", "mat_param2", "mat_disp", "mat_aniso",
              "mat_interior", "fog"):
        a, b = getattr(s, f), getattr(scene_t, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f
    for f in ("env", "delta"):
        a, b = getattr(s, f), getattr(scene_t, f)
        assert (a is None) == (b is None), f
        if a is not None:
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and torch.equal(x, y), f
    assert (s.vol is None) == (scene_t.vol is None)
    if s.vol is not None:
        for f, x in _fields_of(s.vol).items():
            y = getattr(scene_t.vol, f)
            assert (x is None) == (y is None), f
            if x is not None:
                _assert_arrays_equal(x, y, f)


def _media_refusals(builder_cls):
    """The message of each media refusal of a builder class (None where it
    builds): fog then a grid, a grid then fog, scattering with fog,
    scattering with a grid, dispersion with scattering, bad anisotropy
    and negative scattering."""
    dens = np.ones((2, 2, 2), np.float32)

    def grid(b):
        b.set_volume(dens, (0, 0, 0), (1, 1, 1), sigma_s=1.0)

    def scatter(b):
        b.dielectric(1.5, scattering=2.0)

    cases = {
        "fog then grid": lambda b: (b.set_fog(0.2), grid(b)),
        "grid then fog": lambda b: (grid(b), b.set_fog(0.2)),
        "scattering with fog": lambda b: (b.set_fog(0.2), scatter(b),
                                          b.build(**BUILD_KW[builder_cls])),
        "scattering with grid": lambda b: (grid(b), scatter(b),
                                           b.build(**BUILD_KW[builder_cls])),
        "dispersion with scattering": lambda b: b.dielectric(
            1.5, scattering=1.0, dispersion=0.05),
        "fog g": lambda b: b.set_fog(0.2, g=1.0),
        "fog sigma": lambda b: b.set_fog(0.0),
        "grid g": lambda b: b.set_volume(dens, (0, 0, 0), (1, 1, 1), 1.0,
                                         g=-1.0),
        "negative scattering": lambda b: b.dielectric(1.5, scattering=-1.0),
        "scatter g": lambda b: b.dielectric(1.5, scattering=1.0,
                                            scatter_g=1.0),
        "negative density": lambda b: b.set_volume(-dens, (0, 0, 0),
                                                   (1, 1, 1), 1.0),
    }
    out = {}
    for case, fn in cases.items():
        try:
            fn(builder_cls())
            out[case] = None
        except ValueError as e:
            out[case] = str(e)
    return out


def test_builder_refuses_scattering_and_bad_anisotropy():
    from pathtracing_tpu.models.scene import SceneBuilder as JBuilder

    BUILD_KW[JBuilder] = {}
    refusals = _media_refusals(tscene_mod.SceneBuilder)
    assert refusals == _media_refusals(JBuilder)
    assert all(refusals.values()), refusals
    b = tscene_mod.SceneBuilder()
    with pytest.raises(ValueError):
        b.ggx((0.5, 0.5, 0.5), anisotropy=1.0)
    with pytest.raises(ValueError):
        b.spot_light((0, 1, 0), (0, -1, 0), (1, 1, 1), inner_degrees=40.0,
                     outer_degrees=30.0)


def test_checker_builder_matches_jax():
    from pathtracing_tpu.models.scene import SceneBuilder as JBuilder

    bj, bt = JBuilder(), tscene_mod.SceneBuilder()
    for b in (bj, bt):
        b.checker((0.9, 0.1, 0.2), (0.1, 0.8, 0.3), frequency=2.5)
        b.add_sphere((0.0, 0.0, 0.0), 1.0, 0)
    sj, st = bj.build(), bt.build("cpu")
    for f in ("mat_type", "mat_albedo", "mat_param", "mat_emit"):
        _assert_arrays_equal(getattr(sj, f), getattr(st, f), f)


# --- the bench entry point -------------------------------------------------


def test_bench_exits_non_zero_without_a_gpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", BENCH_QUICK="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "pathtracing_tpu_torch.bench"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert out.stdout.strip() == ""


def test_bench_knobs_and_scene_resolution():
    assert bench.bench_config({}) == ("cornell_mesh", 1920, 1080, 4, 8,
                                      False)
    assert bench.bench_config({"BENCH_QUICK": "1"}) == (
        "cornell_mesh", 256, 256, 1, 4, True)
    assert bench.bench_config({"BENCH_SCENE": "glass_demo",
                               "BENCH_WIDTH": "64", "BENCH_HEIGHT": "32",
                               "BENCH_STEPS": "2", "BENCH_DEPTH": "5"}) == (
        "glass_demo", 64, 32, 2, 5, False)
    scene, cam = bench.load_scene("cornell_mesh", True, device="cpu")
    assert scene.tri_v0.shape[0] == 20 * 4 ** 4 + 12
    scene, cam = bench.load_scene("spotlight_demo", False, device="cpu")
    assert scene.delta is not None and cam.vfov_degrees == 40.0
    scene, cam = bench.load_scene("fog_demo", False, device="cpu")
    assert scene.fog is not None and scene.vol is None
    assert bench.bench_engine({}) == "megakernel"
    assert bench.bench_engine({"BENCH_ENGINE": "wavefront"}) == "wavefront"
    with pytest.raises(ValueError, match="BENCH_ENGINE"):
        bench.bench_engine({"BENCH_ENGINE": "reference"})
