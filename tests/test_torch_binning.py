"""Port parity: ray binning (``ops/binning.py``) and binned queries.

``binning_perm``, ``ray_bin`` and ``sort_rays`` (every ``BIN_CONFIGS``
entry, one pass up to 256 bins, the two-pass composition above) give the
JAX package's permutations, bit for bit, on rays with dead lanes: both
are the unique stable grouping. ``intersect_batch`` and
``occluded_batch`` with ``bin_rays`` give their unbinned results bit for
bit (the query runs on the permuted rays and the results come back
through the inverse), on the tree route (a cornell_mesh(3) past a flat
budget cut to 4 clusters, as tests/test_torch_tree.py routes it) and on
an instanced scene with object motion at per-ray shutter times.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.ops import binning as jbin
from pathtracing_tpu.ops import bvh_native
from pathtracing_tpu_torch.models import scene as tscene_mod
from pathtracing_tpu_torch.models import scenes as tscenes
from pathtracing_tpu_torch.ops import binning as tbin
from pathtracing_tpu_torch.ops import bvh as tbvh
from pathtracing_tpu_torch.ops import cluster_trace as tct

torch.set_num_threads(2)


def _rays(n, seed=0):
    rs = np.random.RandomState(seed)
    o = (rs.rand(n, 3) * 3.0 - 1.5).astype(np.float32)
    d = rs.randn(n, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    active = rs.rand(n) > 0.2
    return o, d, active


LO = np.array([-1.0, -1.0, -1.0], np.float32)
HI = np.array([1.0, 1.2, 0.8], np.float32)


def test_constants_match_jax():
    assert tbin.N_CELLS == jbin.N_CELLS and tbin.N_BINS == jbin.N_BINS
    assert tbin.BIN_CONFIGS == jbin.BIN_CONFIGS


@pytest.mark.parametrize("n_bins", [2, 8, 216])
def test_binning_perm_matches_jax(n_bins):
    bins = np.random.RandomState(n_bins).randint(0, n_bins, 3001).astype(
        np.int32)
    pj, ij = jbin.binning_perm(jnp.asarray(bins), n_bins)
    pt, it = tbin.binning_perm(torch.as_tensor(bins), n_bins)
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    assert (bins[pt.numpy()][1:] >= bins[pt.numpy()][:-1]).all()


def test_ray_bin_matches_jax():
    o, d, active = _rays(4099, 1)
    bj = jbin.ray_bin(jnp.asarray(o), jnp.asarray(d), jnp.asarray(LO),
                      jnp.asarray(HI), jnp.asarray(active))
    bt = tbin.ray_bin(torch.as_tensor(o), torch.as_tensor(d),
                      torch.as_tensor(LO), torch.as_tensor(HI),
                      torch.as_tensor(active))
    np.testing.assert_array_equal(np.asarray(bj), bt.numpy())
    assert (bt.numpy()[~active] == tbin.N_BINS - 1).all()


@pytest.mark.parametrize("n_bins", sorted(jbin.BIN_CONFIGS))
def test_sort_rays_matches_jax(n_bins):
    o, d, active = _rays(2053, n_bins)
    # Axis-aligned and tied directions exercise the dominant-axis bin.
    d[:7] = np.array([1.0, 0.0, 0.0], np.float32)
    d[7:14] = np.array([0.0, -1.0, 0.0], np.float32)
    d[14:21] = np.float32(1.0 / np.sqrt(3.0))
    pj, ij = jbin.sort_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(LO),
                            jnp.asarray(HI), jnp.asarray(active), n_bins)
    pt, it = tbin.sort_rays(torch.as_tensor(o), torch.as_tensor(d),
                            torch.as_tensor(LO), torch.as_tensor(HI),
                            torch.as_tensor(active), n_bins)
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    # Dead rays share the last bin, in their original order.
    pos = it.numpy()[~active]
    assert (np.diff(pos) > 0).all()
    assert pos.max() == len(o) - 1 or active[pt.numpy()[-1]]


# --- binned queries ----------------------------------------------------------


@pytest.fixture(scope="module")
def tree_scene():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bvh_native, "build", lambda *a, **k: None)
        mp.setattr(tbvh, "USE_NATIVE", False)
        t, cam = tscenes.cornell_mesh(3, device="cpu")
    return t


def _motion_scene():
    b = tscene_mod.SceneBuilder()
    ground = b.lambertian((0.6, 0.58, 0.52))
    b.add_quad((-3.0, 0.0, -3.0), (6.0, 0.0, 0.0), (0.0, 0.0, 6.0), ground)
    mat = b.ggx((0.9, 0.7, 0.35), roughness=0.25)
    verts, faces = tscenes.icosphere(1, 0.4)
    ts, closes = [], []
    for i in range(5):
        m = np.eye(3, 4)
        m[:, 3] = (i - 2.0, 0.5, 0.3 * i - 0.6)
        ts.append(m)
        m1 = m.copy()
        m1[:, 3] += (0.3, 0.1, -0.2)
        closes.append(m1)
    b.add_instances(verts, faces, mat, ts, motion_transforms=closes)
    return b.build("cpu")


def _query_rays(n, seed):
    rs = np.random.RandomState(seed)
    o = (rs.rand(n, 3) * np.array([6.0, 2.0, 6.0]) - np.array(
        [3.0, -0.2, 3.0])).astype(np.float32)
    d = rs.randn(n, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    active = rs.rand(n) > 0.15
    t_max = (rs.rand(n) * 4.0).astype(np.float32)
    times = rs.rand(n).astype(np.float32)
    return (torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(active),
            torch.as_tensor(t_max), torch.as_tensor(times))


@pytest.mark.parametrize("route", ["tree", "instanced motion"])
@pytest.mark.parametrize("query", ["intersect", "occluded"])
def test_binned_queries_equal_unbinned(tree_scene, monkeypatch, route,
                                       query):
    if route == "tree":
        monkeypatch.setattr(tct, "DNF_MAX_CLUSTERS", 4)
        scene = tree_scene
        assert tscene_mod.cluster_route(scene) == "tree"
        assert not tscene_mod.uses_dnf(scene)
    else:
        scene = _motion_scene()
        assert tscene_mod.has_motion(scene)
    o, d, active, t_max, tm = _query_rays(1501, 4)
    if route == "tree":
        o = o * 0.5     # inside the box
        tm = None
    outs = []
    for bin_rays in (False, True):
        if query == "intersect":
            h = tscene_mod.intersect_batch(scene, o, d, "cluster_torch",
                                           active=active, time=tm,
                                           bin_rays=bin_rays)
            outs.append((h.t, h.slot, h.normal, h.mat_id, h.front, h.valid))
        else:
            outs.append((tscene_mod.occluded_batch(
                scene, o, d, t_max, "cluster_torch", active=active, time=tm,
                bin_rays=bin_rays),))
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if query == "intersect":
        assert bool(outs[0][5].any())
    else:
        assert 0 < int(outs[0][0].sum()) < int(active.sum())
