"""Port parity (b), (c), (d): cluster tables, the traversal's plain
versions, and the scene's closest-hit / any-hit queries.

(b) The port's ``SceneBuilder`` builds ``woop``, ``aabb_*``, ``normal``
    and ``mat`` tables byte-equal to the JAX package's numpy build (the
    native builder is forced off on the JAX side), and the same triangle
    order and light table.
(c) ``trace_torch`` agrees with ``trace_jax`` and with the DNF Pallas
    kernel in interpret mode under the tie contract of
    tests/test_clusters.py: t within rtol 1e-6 on live lanes; slot equal
    or t tied; normals within 1e-4 where the slots agree — with dead
    lanes and a ray count that is not a multiple of the kernel tile.
    ``occluded_torch`` agrees with ``occluded_pallas_dnf`` exactly, and so
    does the flat any hit's plain version, the walk ``occluded_tree_torch``.
(d) ``intersect_batch``/``occluded_batch`` agree with the JAX ones
    (``traversal="cluster_jax"``) on camera rays and random rays, with the
    same tolerances (sphere normals are recomputed from positions: 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.models import scene as jscene_mod
from pathtracing_tpu.models import scenes as jscenes
from pathtracing_tpu.ops import bvh_native
from pathtracing_tpu.ops import cluster_trace as jct
from pathtracing_tpu_torch.models import scene as tscene_mod
from pathtracing_tpu_torch.models import scenes as tscenes
from pathtracing_tpu_torch.ops import cluster_trace as tct

torch.set_num_threads(2)


def _soup(builder_cls, device=None):
    """333 random triangles + two spheres (tests/test_clusters.py's soup)."""
    rs = np.random.RandomState(42)
    b = builder_cls()
    m0 = b.lambertian((0.5, 0.5, 0.5))
    m1 = b.metal((0.8, 0.8, 0.8))
    for i in range(333):
        c = rs.randn(3) * 1.5
        v = c + rs.randn(3, 3) * 0.25
        b.add_triangle(v[0], v[1], v[2], m0 if i % 2 else m1)
    b.add_sphere((0.0, 0.0, 0.0), 0.4, m0)
    b.add_sphere((1.0, 1.0, 0.0), 0.3, m1)
    return b.build() if device is None else b.build(device)


@pytest.fixture(scope="module")
def scenes():
    """{name: (jax scene, port scene from its own builder)}."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bvh_native, "build", lambda *a, **k: None)
        mesh_j, _ = jscenes.cornell_mesh(3)
        soup_j = _soup(jscene_mod.SceneBuilder)
    mesh_t, _ = tscenes.cornell_mesh(3, device="cpu")
    soup_t = _soup(tscene_mod.SceneBuilder, "cpu")
    return {"mesh": (mesh_j, mesh_t), "soup": (soup_j, soup_t)}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def random_rays(n, seed, spread=0.3, center=(0.0, 0.0, 3.0)):
    rs = np.random.RandomState(seed)
    o = np.repeat([center], n, 0) + rs.randn(n, 3) * spread
    d = rs.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("name", ["mesh", "soup"])
@pytest.mark.parametrize("field", ["aabb_min", "aabb_max", "woop", "normal",
                                   "mat"])
def test_cluster_tables_byte_equal(scenes, name, field):
    j, t = scenes[name]
    a = _np(getattr(j.clusters, field))
    b = _np(getattr(t.clusters, field))
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["mesh", "soup"])
def test_triangle_order_and_lights_equal(scenes, name):
    j, t = scenes[name]
    for field in ("tri_v0", "tri_e1", "tri_e2", "tri_mat", "sph_center",
                  "mat_type", "mat_albedo", "mat_param", "mat_emit"):
        assert _np(getattr(j, field)).tobytes() == _np(
            getattr(t, field)).tobytes(), field
    for field in tscene_mod.lights.LightTable._fields:
        a, b = getattr(j.lights, field), getattr(t.lights, field)
        if a is None or b is None:      # kind / packed: absent in both
            assert a is None and b is None, field
            continue
        assert _np(a).tobytes() == _np(b).tobytes(), field


def test_scene_from_numpy_round_trip(scenes):
    j, t = scenes["mesh"]
    s = tscene_mod.scene_from_numpy(jax.tree.map(np.asarray, j), "cpu")
    for field in ("tri_v0", "sph_radius", "mat_type"):
        assert torch.equal(getattr(s, field), getattr(t, field))
    assert torch.equal(s.clusters.woop, t.clusters.woop)


def test_scene_from_numpy_refuses_unported_fields(scenes):
    """No JAX Scene field is refused any more (the media fields were the
    last): a fog row given to ``scene_from_numpy`` comes across as is."""
    j, _ = scenes["mesh"]
    arrays = jax.tree.map(np.asarray, j)._asdict()
    arrays["fog"] = np.array([0.2, 0.01, 0.3], np.float32)
    s = tscene_mod.scene_from_numpy(arrays, "cpu")
    assert torch.equal(s.fog, torch.tensor([0.2, 0.01, 0.3]))
    assert s.vol is None and s.mat_interior is None


def _t0(n):
    t0 = np.full(n, 3.0e38, np.float32)
    t0[::11] = 0.0          # dead lanes
    return t0


# XLA:CPU contracts multiply-adds inside the jitted JAX sweep where torch
# eager does not (docs/PERF_TPU_v5e_history.md, "Correctness gotcha 2"); the soup's thin random
# triangles amplify that one-ulp difference in the Woop products to ~1e-6
# relative in t, so the soup gets 1e-5. The mesh keeps the contract's 1e-6.
RTOL = {"mesh": 1e-6, "soup": 1e-5}


def _assert_tie_contract(ref, new, t0, rtol=1e-6):
    live = t0 > 0
    t_r, t_n = _np(ref[0]), _np(new[0])
    np.testing.assert_allclose(np.where(live, t_r, 0.0),
                               np.where(live, t_n, 0.0), rtol=rtol)
    s_r, s_n = _np(ref[1]), _np(new[1])
    slot_match = s_r == s_n
    assert np.all(slot_match | (t_r == t_n) | ~live)
    same = slot_match & live & (s_r >= 0)
    np.testing.assert_allclose(_np(ref[2])[same], _np(new[2])[same],
                               atol=1e-4)
    np.testing.assert_array_equal(_np(ref[3])[same], _np(new[3])[same])


@pytest.mark.parametrize("name", ["mesh", "soup"])
def test_trace_torch_matches_trace_jax(scenes, name):
    j, t = scenes[name]
    o, d = random_rays(600, 2)              # 600: not a tile multiple
    t0 = _t0(600)
    ref = jct.trace_jax(j.clusters, jnp.asarray(o), jnp.asarray(d),
                        jnp.asarray(t0))
    new = tct.trace_torch(t.clusters, torch.as_tensor(o), torch.as_tensor(d),
                          torch.as_tensor(t0))
    _assert_tie_contract(ref, new, t0, RTOL[name])
    # Misses keep t_init and report slot -1, normal 0, mat 0.
    miss = _np(new[1]) < 0
    np.testing.assert_array_equal(_np(new[0])[miss], t0[miss])
    assert not _np(new[2])[miss].any() and not _np(new[3])[miss].any()


def test_trace_torch_matches_dnf_kernel_interpret(scenes):
    j, t = scenes["mesh"]
    o, d = random_rays(300, 5)
    t0 = _t0(300)
    ref = jct.trace_pallas_dnf(j.clusters, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(t0), interpret=True)
    new = tct.trace(t.clusters, torch.as_tensor(o), torch.as_tensor(d),
                    torch.as_tensor(t0))
    _assert_tie_contract(ref, new, t0)


def test_occluded_torch_matches_dnf_kernel_interpret(scenes):
    j, t = scenes["mesh"]
    o, d = random_rays(300, 6)
    rs = np.random.RandomState(6)
    cap = (rs.rand(300) * 4.0).astype(np.float32)
    cap[::11] = 0.0
    ref = jct.occluded_pallas_dnf(j.clusters, jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(cap), interpret=True)
    new = tct.occluded(t.clusters, torch.as_tensor(o), torch.as_tensor(d),
                       torch.as_tensor(cap))
    np.testing.assert_array_equal(_np(ref), _np(new))
    assert 0 < int(_np(new).sum()) < 300 - 28


@pytest.mark.parametrize("name", ["mesh", "soup"])
def test_occluded_torch_matches_trace_jax_oracle(scenes, name):
    j, t = scenes[name]
    o, d = random_rays(500, 9)
    cap = (np.random.RandomState(9).rand(500) * 5.0).astype(np.float32)
    cap[::11] = 0.0
    _, slot, _, _ = jct.trace_jax(j.clusters, jnp.asarray(o),
                                  jnp.asarray(d), jnp.asarray(cap))
    new = tct.occluded_torch(t.clusters, torch.as_tensor(o),
                             torch.as_tensor(d), torch.as_tensor(cap))
    np.testing.assert_array_equal(np.asarray(slot) >= 0, _np(new))


def test_trace_stats_count_the_sweep(scenes):
    _, t = scenes["mesh"]
    o, d = random_rays(64, 3)
    t0 = _t0(64)
    stats = {}
    tct.trace_torch(t.clusters, torch.as_tensor(o), torch.as_tensor(d),
                    torch.as_tensor(t0), stats=stats)
    n_clusters = t.clusters.woop.shape[0]
    assert stats["slab_tests"] <= int((t0 > 0).sum()) * n_clusters
    assert 0 < stats["cluster_evals"] <= stats["slab_tests"]


def _camera_rays(n_side=24):
    """Cornell camera rays through a jittered n_side² grid."""
    from pathtracing_tpu_torch.ops import camera as tcam

    cam = tcam.build_camera(jscenes.CORNELL_CAMERA, 1.0, device="cpu")
    rs = np.random.RandomState(1)
    s = torch.as_tensor(rs.rand(n_side * n_side).astype(np.float32))
    tt = torch.as_tensor(rs.rand(n_side * n_side).astype(np.float32))
    z = torch.zeros_like(s)
    o, d = tcam.generate_ray(cam, s, tt, z, z)
    return o.numpy(), d.numpy()


def _hit_match(hj, ht, rtol):
    vj, vt = np.asarray(hj.valid), ht.valid.numpy()
    np.testing.assert_array_equal(vj, vt)
    np.testing.assert_allclose(np.asarray(hj.t)[vj], ht.t.numpy()[vt],
                               rtol=rtol)
    np.testing.assert_allclose(np.asarray(hj.normal)[vj],
                               ht.normal.numpy()[vt], atol=1e-4)
    np.testing.assert_array_equal(np.asarray(hj.mat_id), ht.mat_id.numpy())
    np.testing.assert_array_equal(np.asarray(hj.front)[vj],
                                  ht.front.numpy()[vt])
    np.testing.assert_array_equal(np.asarray(hj.tri), ht.tri.numpy())


@pytest.mark.parametrize("name", ["mesh", "soup"])
@pytest.mark.parametrize("rays", ["camera", "random"])
def test_intersect_batch_matches_jax(scenes, name, rays):
    j, t = scenes[name]
    o, d = _camera_rays() if rays == "camera" else random_rays(400, 11)
    active = np.ones(o.shape[0], bool)
    active[::7] = False
    hj = jscene_mod.intersect_batch(j, jnp.asarray(o), jnp.asarray(d),
                                    "cluster_jax", active=jnp.asarray(active))
    ht = tscene_mod.intersect_batch(t, torch.as_tensor(o),
                                    torch.as_tensor(d), "cluster_torch",
                                    active=torch.as_tensor(active))
    m = active
    _hit_match(jax.tree.map(lambda x: x[m], hj),
               tscene_mod.Hit(*(x[torch.as_tensor(m)] for x in ht)),
               RTOL[name])


@pytest.mark.parametrize("name", ["mesh", "soup"])
@pytest.mark.parametrize("rays", ["camera", "random"])
def test_occluded_batch_matches_jax(scenes, name, rays):
    j, t = scenes[name]
    o, d = _camera_rays() if rays == "camera" else random_rays(400, 12)
    n = o.shape[0]
    t_max = (np.random.RandomState(n).rand(n) * 4.0).astype(np.float32)
    active = np.ones(n, bool)
    active[::5] = False
    oj = jscene_mod.occluded_batch(j, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(t_max), "cluster_jax",
                                   active=jnp.asarray(active))
    ot = tscene_mod.occluded_batch(t, torch.as_tensor(o), torch.as_tensor(d),
                                   torch.as_tensor(t_max), "cluster_torch",
                                   active=torch.as_tensor(active))
    np.testing.assert_array_equal(np.asarray(oj), ot.numpy())


def test_routes_agree_on_cpu_tensors(scenes):
    """On CPU tensors the dispatching wrappers are the plain versions."""
    _, t = scenes["soup"]
    o, d = random_rays(200, 4)
    args = (torch.as_tensor(o), torch.as_tensor(d))
    ha = tscene_mod.intersect_batch(t, *args, "cluster_torch")
    hb = tscene_mod.intersect_batch(t, *args, "cluster_cuda")
    for a, b in zip(ha, hb):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="traversal"):
        tscene_mod.intersect_batch(t, *args, "cluster_jax")


# --- the flat closest hit's walk of the set's cluster tree ----------------


def _walk(t, o, d, t0, **kw):
    return tct.trace_flat_walk_torch(t.clusters, torch.as_tensor(o),
                                     torch.as_tensor(d), torch.as_tensor(t0),
                                     **kw)


@pytest.mark.parametrize("name", ["mesh", "soup"])
@pytest.mark.parametrize("oracle", ["trace_jax", "dnf_kernel_interpret"])
def test_flat_walk_matches_jax(scenes, name, oracle):
    """The walk (the flat kernel's plain version) meets the tie contract
    against the JAX sweep and the JAX DNF kernel, dead lanes included."""
    j, t = scenes[name]
    # 529 and 333 rays: not warp multiples.
    o, d = _camera_rays(23) if name == "mesh" else random_rays(333, 21)
    t0 = _t0(o.shape[0])
    args = (j.clusters, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t0))
    if oracle == "trace_jax":
        ref = jct.trace_jax(*args)
    else:
        ref = jct.trace_pallas_dnf(*args, interpret=True)
    new = _walk(t, o, d, t0)
    _assert_tie_contract(ref, new, t0, RTOL[name])
    assert int((_np(new[1]) >= 0).sum()) > 20


@pytest.mark.parametrize("name", ["mesh", "soup"])
def test_flat_walk_keeps_trace_torch_t_bit_for_bit(scenes, name):
    """Against the index-order sweep the walk keeps t bit for bit (dead
    lanes pass t_init through), the slot or a tied t, and reads normal and
    material from the tables at its own slot (0 on a miss)."""
    _, t = scenes[name]
    o, d = random_rays(701, 22)
    t0 = _t0(701)
    t0[3::17] = np.random.RandomState(22).rand(len(t0[3::17])) * 2.0
    ref = tct.trace_torch(t.clusters, *(torch.as_tensor(a)
                                        for a in (o, d, t0)))
    new = _walk(t, o, d, t0)
    assert torch.equal(new[0], ref[0])
    assert bool(((new[1] == ref[1]) | (new[0] == ref[0])).all())
    hit = new[1] >= 0
    assert int(hit.sum()) > 20
    normal, mat = tct.lookup_hit(t.clusters, new[1])
    assert torch.equal(new[2][hit], normal[hit])
    assert torch.equal(new[3][hit], mat[hit])
    assert not bool(new[2][~hit].any()) and not bool(new[3][~hit].any())


def test_flat_route_is_the_walk(scenes):
    """The flat closest hit's route pairs the walk with the kernel wrapper,
    and on CPU tensors the wrapper is the walk."""
    route = tscene_mod._ROUTES["trace", "flat"]
    assert route == (tct.trace_flat_walk_torch, tct.trace)
    _, t = scenes["mesh"]
    o, d = random_rays(97, 23)
    t0 = _t0(97)
    args = [torch.as_tensor(a) for a in (o, d, t0)]
    for a, b in zip(tct.trace(t.clusters, *args), _walk(t, o, d, t0)):
        assert torch.equal(a, b)


def test_flat_walk_refuses_a_set_without_tree(scenes):
    _, t = scenes["mesh"]
    o, d = random_rays(8, 24)
    args = [torch.as_tensor(a) for a in (o, d, _t0(8))]
    for field in ("node_box", "oct_links"):
        bare = t.clusters._replace(**{field: None})
        with pytest.raises(ValueError, match=f"no cluster tree.*{field}"):
            tct.trace(bare, *args)
        with pytest.raises(ValueError, match=field):
            tct._tree_args(bare, torch.device("cpu"))


def test_scene_from_numpy_builds_a_missing_tree(scenes):
    """A JAX set that comes without its tree gets one over its clusters:
    the same tree ``SceneBuilder.build`` gives, so the walk finds the
    same hits."""
    j, t = scenes["mesh"]
    arrays = jax.tree.map(np.asarray, j)._asdict()
    arrays["clusters"] = arrays["clusters"]._replace(
        node_box=None, node_meta=None, oct_links=None)
    s = tscene_mod.scene_from_numpy(arrays, "cpu")
    for f in ("node_box", "node_meta", "oct_links"):
        assert torch.equal(getattr(s.clusters, f), getattr(t.clusters, f)), f
    o, d = random_rays(50, 25)
    t0 = _t0(50)
    for a, b in zip(_walk(s, o, d, t0), _walk(t, o, d, t0)):
        assert torch.equal(a, b)


def test_with_tree_leaves_are_the_real_clusters():
    """Built over a paged flat set, the tree's leaves are its real clusters,
    each once; padding clusters (inverted boxes) stay out."""
    from pathtracing_tpu_torch.ops import clusters as tcl

    rs = np.random.RandomState(26)
    v0 = rs.rand(1500, 3).astype(np.float32) * 4.0
    e = (rs.randn(2, 1500, 3) * 0.05).astype(np.float32)
    cs = tcl.build_clusters(v0, e[0], e[1], np.zeros(1500, np.int32))[0]
    flat, _, _ = tcl.build_pages(cs, 5)
    real = np.nonzero((flat.aabb_min <= flat.aabb_max).all(axis=1))[0]
    assert len(real) < flat.aabb_min.shape[0]
    built = tcl.with_tree(flat._replace(node_box=None, node_meta=None,
                                        oct_links=None))
    leaves = built.node_meta[1][built.node_meta[1] >= 0]
    assert sorted(leaves.tolist()) == real.tolist()
    assert tcl.with_tree(flat) is flat


# --- the flat any hit's walk of the set's cluster tree --------------------


def _shadow_caps(n, seed):
    """Caps of a shadow wave: uniform in (0, 6), every 11th lane dead and
    every 7th capped short of most surfaces."""
    rs = np.random.RandomState(seed)
    cap = (rs.rand(n) * 6.0).astype(np.float32)
    cap[::7] = (rs.rand(len(cap[::7])) * 0.05).astype(np.float32)
    cap[::11] = 0.0
    return cap


def test_flat_any_hit_route_is_the_walk(scenes):
    """The flat any hit's route pairs the walk with the kernel wrapper, and
    on CPU tensors the wrapper is the walk."""
    route = tscene_mod._ROUTES["occluded", "flat"]
    assert route == (tct.occluded_tree_torch, tct.occluded)
    _, t = scenes["mesh"]
    o, d = random_rays(97, 27)
    args = [torch.as_tensor(a) for a in (o, d, _shadow_caps(97, 27))]
    occ = tct.occluded(t.clusters, *args)
    assert torch.equal(occ, tct.occluded_tree_torch(t.clusters, *args))
    assert 0 < int(occ.sum()) < 97


@pytest.mark.parametrize("name", ["mesh", "soup"])
def test_flat_any_hit_walk_matches_jax(scenes, name):
    """The walk (the flat any-hit kernel's plain version) equals the
    index-order sweep ``occluded_torch`` and the JAX DNF any-hit kernel
    exactly, with dead lanes and lanes capped short, at ray counts that
    are not warp multiples (529 and 333)."""
    j, t = scenes[name]
    o, d = _camera_rays(23) if name == "mesh" else random_rays(333, 28)
    cap = _shadow_caps(o.shape[0], 28)
    ref = jct.occluded_pallas_dnf(j.clusters, jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(cap), interpret=True)
    args = [torch.as_tensor(a) for a in (o, d, cap)]
    walk = tct.occluded_tree_torch(t.clusters, *args)
    assert torch.equal(walk, tct.occluded_torch(t.clusters, *args))
    np.testing.assert_array_equal(_np(ref), _np(walk))
    live = cap > 0
    assert 10 < int(_np(walk).sum()) < int(live.sum()) - 10
    assert not _np(walk)[~live].any()


def test_flat_any_hit_refuses_a_set_without_tree(scenes):
    _, t = scenes["mesh"]
    o, d = random_rays(8, 29)
    args = [torch.as_tensor(a) for a in (o, d, _shadow_caps(8, 29))]
    for field in ("node_box", "node_meta", "oct_links"):
        bare = t.clusters._replace(**{field: None})
        with pytest.raises(ValueError, match=f"no cluster tree.*{field}"):
            tct.occluded(bare, *args)
