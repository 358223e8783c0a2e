"""Port parity for big scenes: the cluster tree, the octant links, HBM
pages and the paged route, fed the same numpy inputs in both packages.

Tolerances and why:
  * ``build_cluster_tree``, ``build_octant_trees``, ``partition_pages``,
    ``build_pages`` and ``SceneBuilder.build(page_clusters=...)``: byte
    equal (the same numpy code; the JAX side's native BVH builder is
    forced off and the port's ``bvh.USE_NATIVE`` with it). The port drops
    only the TPU lookahead kernel's ``cand_box``;
  * the paged route against the JAX paged kernel in interpret mode
    (``"cluster_interpret"``), and the per-page tree walk against the JAX
    ``trace_pallas_paged`` in interpret mode: the tie contract of
    tests/test_clusters.py:118-145 — t within rtol 1e-6 on live lanes
    (1e-5 for the soup, as in tests/test_torch_clusters.py: XLA:CPU
    contracts multiply-adds where torch eager does not, and the soup's
    thin triangles amplify that ulp to ~4e-6 in t), slot equal or t tied,
    normals within 1e-4 and materials equal where the slots agree;
    occlusion equal;
  * inside the port (paged sweep ≡ flat sweep over the padded set; the
    paged any hit ≡ the capped paged sweep's ``slot >= 0``): bitwise; the
    paged walk (the kernel's order) against the index-order sweep: t
    bitwise, slot equal or t tied, normal and material equal where the
    slots agree;
  * the 24x24 render: ≤ 1% of pixels over 1e-3, means within 1% (the
    render tolerance of tests/test_torch_render.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.models import progressive as jprog
from pathtracing_tpu.models import scene as jscene_mod
from pathtracing_tpu.models import scenes as jscenes
from pathtracing_tpu.ops import bvh_native
from pathtracing_tpu.ops import cluster_trace as jct
from pathtracing_tpu.ops import clusters as jcl
from pathtracing_tpu.ops.camera import build_camera as jcamera
from pathtracing_tpu.utils.config import RenderConfig as JConfig
from pathtracing_tpu_torch.models import megakernel as tmega
from pathtracing_tpu_torch.models import progressive as tprog
from pathtracing_tpu_torch.models import scene as tscene_mod
from pathtracing_tpu_torch.models import scenes as tscenes
from pathtracing_tpu_torch.ops import bvh as tbvh
from pathtracing_tpu_torch.ops import cluster_trace as tct
from pathtracing_tpu_torch.ops import clusters as tcl
from pathtracing_tpu_torch.ops.camera import build_camera as tcamera
from pathtracing_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(2)

# (name, page size of the scene build): the soup packs into 3 clusters.
PAGED = {"mesh": 16, "soup": 1}
RTOL = {"mesh": 1e-6, "soup": 1e-5}


def _soup_builder(builder_cls):
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
    return b


BUILDERS = {
    "mesh": (lambda: jscenes._cornell_mesh_builder(3),
             lambda: tscenes.cornell_mesh_builder(3)),
    "soup": (lambda: _soup_builder(jscene_mod.SceneBuilder),
             lambda: _soup_builder(tscene_mod.SceneBuilder)),
}


@pytest.fixture(scope="module")
def scenes():
    """{name: (jax scene, port scene)}, both built with ``page_clusters``
    and NumPy BVHs."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bvh_native, "build", lambda *a, **k: None)
        mp.setattr(tbvh, "USE_NATIVE", False)
        for name, (jb, tb) in BUILDERS.items():
            out[name] = (jb().build(page_clusters=PAGED[name]),
                         tb().build("cpu", page_clusters=PAGED[name]))
    return out


@pytest.fixture(scope="module")
def cluster_sets(scenes):
    """{name: the JAX package's unpaged numpy ClusterSet} of each scene's
    stored triangles (the input of the tree and page builders)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bvh_native, "build", lambda *a, **k: None)
        for name, (j, _) in scenes.items():
            v0, e1, e2 = (np.asarray(getattr(j, f))
                          for f in ("tri_v0", "tri_e1", "tri_e2"))
            out[name] = jcl.build_clusters(v0, e1, e2,
                                           np.asarray(j.tri_mat))[0]
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bytes_equal(a, b, what):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_build_cluster_tree_byte_equal(cluster_sets, name):
    cs = cluster_sets[name]
    ref = jcl.build_cluster_tree(cs.aabb_min, cs.aabb_max)
    new = tcl.build_cluster_tree(cs.aabb_min, cs.aabb_max)
    for i, (a, b) in enumerate(zip(ref, new)):
        _bytes_equal(a, b, f"output {i}")
    assert ref[0].shape[1] == 2 * cs.aabb_min.shape[0] - 1


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_build_octant_trees_byte_equal(cluster_sets, name):
    cs = cluster_sets[name]
    _, _, child, axis, flo = jcl.build_cluster_tree(cs.aabb_min, cs.aabb_max)
    _bytes_equal(jcl.build_octant_trees(child, axis, flo),
                 tcl.build_octant_trees(child, axis, flo), "oct_links")


def test_cluster_set_carries_the_tree():
    """``build_clusters`` returns the tree fields, byte equal."""
    rs = np.random.RandomState(1)
    v0 = rs.randn(500, 3).astype(np.float32)
    e1 = (rs.randn(500, 3) * 0.1).astype(np.float32)
    e2 = (rs.randn(500, 3) * 0.1).astype(np.float32)
    mat = np.arange(500, dtype=np.int32) % 3
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbvh, "USE_NATIVE", False)
        mp.setattr(bvh_native, "build", lambda *a, **k: None)
        ref = jcl.build_clusters(v0, e1, e2, mat)[0]
        new = tcl.build_clusters(v0, e1, e2, mat)[0]
    for f in tcl.ClusterSet._fields:
        _bytes_equal(getattr(ref, f), getattr(new, f), f)
    assert new.node_box.shape[1] == 2 * new.woop.shape[0] - 1


@pytest.mark.parametrize("page_size", [1, 3, 4, 7])
def test_partition_pages_equal(cluster_sets, page_size):
    cs = cluster_sets["mesh"]
    ref = jcl.partition_pages(cs.aabb_min, cs.aabb_max, page_size)
    new = tcl.partition_pages(cs.aabb_min, cs.aabb_max, page_size)
    assert len(ref) == len(new) >= 2
    for a, b in zip(ref, new):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,page_size", [("mesh", 4), ("mesh", 7),
                                            ("soup", 2)])
def test_build_pages_byte_equal(cluster_sets, name, page_size):
    cs = cluster_sets[name]
    flat_j, pages_j, remap_j = jcl.build_pages(cs, page_size)
    port_cs = tcl.ClusterSet(**{f: getattr(cs, f)
                                for f in tcl.ClusterSet._fields})
    flat_t, pages_t, remap_t = tcl.build_pages(port_cs, page_size)
    for f in tcl.ClusterSet._fields:
        _bytes_equal(getattr(flat_j, f), getattr(flat_t, f), f)
    for f in ("node_box", "node_meta", "oct_links"):
        _bytes_equal(getattr(pages_j, f), getattr(pages_t, f), f)
    assert pages_t.cand_box is None
    parts = jcl.partition_pages(cs.aabb_min, cs.aabb_max, page_size)
    _bytes_equal(np.array([len(ids) for ids in parts], np.int32),
                 pages_t.n_real, "n_real")
    _bytes_equal(remap_j, remap_t, "remap")
    # The global tree is the same whether build_pages builds it or takes
    # it from the ClusterSet.
    bare = port_cs._replace(node_box=None, node_meta=None, oct_links=None)
    rebuilt = tcl.build_pages(bare, page_size)[0]
    for f in ("node_box", "node_meta", "oct_links"):
        _bytes_equal(getattr(flat_t, f), getattr(rebuilt, f), f)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_scene_build_pages_byte_equal(scenes, name):
    j, t = scenes[name]
    assert t.pages is not None and t.pages.node_box.shape[0] >= 2
    assert tscene_mod.cluster_route(t) == "paged"
    assert tscene_mod.uses_dnf(t)
    for f in tcl.ClusterSet._fields:
        _bytes_equal(getattr(j.clusters, f), getattr(t.clusters, f), f)
    for f in ("node_box", "node_meta", "oct_links"):
        _bytes_equal(getattr(j.pages, f), getattr(t.pages, f), f)
    for f in ("tri_v0", "tri_e1", "tri_e2", "tri_mat"):
        _bytes_equal(getattr(j, f), getattr(t, f), f)


def test_scene_from_numpy_carries_pages(scenes):
    j, t = scenes["mesh"]
    s = tscene_mod.scene_from_numpy(jax.tree.map(np.asarray, j), "cpu")
    for f in ("node_box", "node_meta", "oct_links"):
        assert torch.equal(getattr(s.pages, f), getattr(t.pages, f)), f
        assert torch.equal(getattr(s.clusters, f), getattr(t.clusters, f))
    assert torch.equal(s.pages.n_real, t.pages.n_real)
    assert s.pages.cand_box is None
    assert tscene_mod.cluster_route(s) == "paged"


def test_instanced_scenes_refuse_paging():
    b = tscene_mod.SceneBuilder()
    verts, faces = tscenes.icosphere(1, 0.5)
    b.add_instances(verts, faces, b.lambertian((0.5, 0.5, 0.5)),
                    [np.eye(4)])
    with pytest.raises(ValueError, match="cannot page"):
        b.build("cpu", page_clusters=4)


def _rays(n, seed, spread=0.3, center=(0.0, 0.0, 3.0)):
    rs = np.random.RandomState(seed)
    o = np.repeat([center], n, 0) + rs.randn(n, 3) * spread
    d = rs.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _assert_tie_contract(ref, new, live, rtol=1e-6):
    t_r, t_n = _np(ref[0]), _np(new[0])
    np.testing.assert_allclose(np.where(live, t_r, 0.0),
                               np.where(live, t_n, 0.0), rtol=rtol)
    s_r, s_n = _np(ref[1]), _np(new[1])
    slot_match = s_r == s_n
    assert np.all(slot_match | (t_r == t_n) | ~live)
    same = slot_match & live & (s_r >= 0)
    assert same.sum() > 10
    np.testing.assert_allclose(_np(ref[2])[same], _np(new[2])[same],
                               atol=1e-4)
    np.testing.assert_array_equal(_np(ref[3])[same], _np(new[3])[same])


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_paged_intersect_batch_matches_jax_kernel(scenes, name):
    j, t = scenes[name]
    n = 1001                                # not a multiple of 128
    o, d = (_rays(n, 4) if name == "mesh"
            else _rays(n, 3, spread=1.5, center=(0, 0, 4)))
    active = np.ones(n, bool)
    active[::11] = False                    # dead lanes
    hj = jscene_mod.intersect_batch(j, jnp.asarray(o), jnp.asarray(d),
                                    "cluster_interpret",
                                    active=jnp.asarray(active))
    ht = tscene_mod.intersect_batch(t, torch.as_tensor(o),
                                    torch.as_tensor(d), "cluster_cuda",
                                    active=torch.as_tensor(active))
    _assert_tie_contract((hj.t, hj.slot, hj.normal, hj.mat_id),
                         (ht.t, ht.slot, ht.normal, ht.mat_id), active,
                         RTOL[name])
    np.testing.assert_array_equal(np.asarray(hj.valid)[active],
                                  ht.valid.numpy()[active])


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_paged_occluded_batch_matches_jax_kernel(scenes, name):
    j, t = scenes[name]
    n = 700
    o, d = (_rays(n, 8, spread=0.8, center=(0.0, -0.3, 0.5))
            if name == "mesh" else _rays(n, 9, spread=1.5, center=(0, 0, 0)))
    t_max = (np.random.RandomState(3).rand(n) * 2.0).astype(np.float32)
    active = t_max > 0.2
    oj = jscene_mod.occluded_batch(j, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(t_max), "cluster_interpret",
                                   active=jnp.asarray(active))
    ot = tscene_mod.occluded_batch(t, torch.as_tensor(o), torch.as_tensor(d),
                                   torch.as_tensor(t_max), "cluster_torch",
                                   active=torch.as_tensor(active))
    np.testing.assert_array_equal(np.asarray(oj), ot.numpy())
    assert 20 < ot.sum() < n - 20


def _wave(t, n=1501, seed=4):
    o, d = _rays(n, seed)
    t0 = np.full(n, 3.0e38, np.float32)
    t0[::11] = 0.0
    return torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t0)


def test_paged_sweep_equals_flat_sweep_bitwise(scenes):
    """Over the same padded set, the paged sweep gives the flat sweep's
    t, slot, normal and mat bit for bit, on closest-hit and capped waves."""
    _, t = scenes["mesh"]
    o, d, t0 = _wave(t)
    for cap in (t0, torch.where(t0 > 0, 1.5, 0.0)):
        ref = tct.trace_torch(t.clusters, o, d, cap)
        new = tct.trace_paged_dnf_torch(t.clusters, t.pages, o, d, cap)
        for a, b in zip(ref, new):
            assert torch.equal(a, b)


def test_padding_clusters_are_never_evaluated(scenes):
    """Padding clusters have inverted boxes, which the slab test passes for
    every ray: the flat sweep over the padded set evaluates each of them
    once per live ray (their Woop data always misses), the paged sweep
    none of them, and it makes every other evaluation of the flat sweep."""
    _, t = scenes["mesh"]
    o, d, t0 = _wave(t)
    n_pages, page_size, n_real = tct.page_shape(t.clusters, t.pages)
    n_pad = n_pages * page_size - int(n_real.sum())
    assert n_pad > 0
    live = int((t0 > 0).sum())
    flat, paged = {}, {}
    tct.trace_torch(t.clusters, o, d, t0, stats=flat)
    tct.trace_paged_dnf_torch(t.clusters, t.pages, o, d, t0, stats=paged)
    assert flat["cluster_evals"] - paged["cluster_evals"] == n_pad * live
    assert paged["cluster_evals"] > 0


def test_paged_wrapper_refuses_other_devices(scenes):
    _, t = scenes["mesh"]
    cl = tcl.ClusterSet(*(x.to("meta") for x in t.clusters))
    pages = tcl.PageSet(*(None if x is None else x.to("meta")
                          for x in t.pages))
    o = torch.zeros((4, 3), device="meta")
    before = dict(tct.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tct.trace_paged_dnf(cl, pages, o, o, torch.ones(4, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tct.trace_tree_paged(cl, pages, o, o, torch.ones(4, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tct.occluded_paged_dnf(cl, pages, o, o, torch.ones(4, device="meta"))
    assert tct.LAUNCHES == before


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_paged_walk_matches_jax_kernel(scenes, name):
    """The paged walk (the kernel's visiting order) against the JAX paged
    kernel in interpret mode, under the tie contract."""
    j, t = scenes[name]
    o, d = (_rays(501, 4) if name == "mesh"
            else _rays(501, 3, spread=1.5, center=(0, 0, 4)))
    t0 = np.full(501, 3.0e38, np.float32)
    t0[::11] = 0.0
    ref = jct.trace_pallas_paged_dnf(j.clusters, j.pages, jnp.asarray(o),
                                     jnp.asarray(d), jnp.asarray(t0),
                                     interpret=True)
    new = tct.trace_paged_walk_torch(t.clusters, t.pages,
                                     *(torch.as_tensor(a) for a in (o, d, t0)))
    _assert_tie_contract(ref, new, t0 > 0, RTOL[name])


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_tree_paged_walk_matches_jax_kernel(scenes, name):
    """The per-page tree walk in its kernel's order (pages nearest first,
    normal from the Woop w-row) against the JAX ``trace_pallas_paged`` in
    interpret mode, under the tie contract, on 501 rays with dead lanes.
    The mesh has more nodes per page tree than clusters per page, the soup
    (one cluster a page) as many."""
    j, t = scenes[name]
    o, d = (_rays(501, 6) if name == "mesh"
            else _rays(501, 7, spread=1.5, center=(0, 0, 4)))
    t0 = np.full(501, 3.0e38, np.float32)
    t0[::11] = 0.0
    _, page_size, _ = tct.page_shape(t.clusters, t.pages)
    assert (t.pages.node_box.shape[2] != page_size) == (name == "mesh")
    ref = jct.trace_pallas_paged(j.clusters, j.pages, jnp.asarray(o),
                                 jnp.asarray(d), jnp.asarray(t0),
                                 interpret=True)
    new = tct.trace_tree_paged_walk_torch(
        t.clusters, t.pages, *(torch.as_tensor(a) for a in (o, d, t0)))
    _assert_tie_contract(ref, new, t0 > 0, RTOL[name])


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_paged_walk_equals_index_order_sweep(scenes, name):
    """Against the index-order sweep ``trace_paged_dnf_torch``: t bit for
    bit, slot equal or t tied, normal and material equal where the slots
    agree, on closest-hit and capped waves; ``trace_paged_dnf`` takes the
    walk for CPU tensors."""
    _, t = scenes[name]
    o, d, t0 = (_wave(t) if name == "mesh" else
                (torch.as_tensor(a) for a in (*_rays(1501, 3, spread=1.5,
                                                     center=(0, 0, 4)),
                                              _wave(t)[2])))
    for cap in (t0, torch.where(t0 > 0, 3.0, 0.0)):
        ref = tct.trace_paged_dnf_torch(t.clusters, t.pages, o, d, cap)
        new = tct.trace_paged_walk_torch(t.clusters, t.pages, o, d, cap)
        assert torch.equal(ref[0], new[0])
        same = ref[1] == new[1]
        assert bool((same | (ref[0] == new[0])).all())
        assert int((same & (ref[1] >= 0)).sum()) > 20
        assert torch.equal(ref[2][same], new[2][same])
        assert torch.equal(ref[3][same], new[3][same])
        for a, b in zip(new, tct.trace_paged_dnf(t.clusters, t.pages, o, d,
                                                 cap)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_occluded_paged_matches_jax_paged_occlusion(scenes, name):
    """``occluded_paged_dnf``'s plain version against the JAX package's
    paged occlusion (its paged kernel's ``slot >= 0``, interpret mode) and
    against the walk's capped closest hit: bit for bit."""
    j, t = scenes[name]
    n = 700
    o, d = (_rays(n, 8, spread=0.8, center=(0.0, -0.3, 0.5))
            if name == "mesh" else _rays(n, 9, spread=1.5, center=(0, 0, 0)))
    cap = (np.random.RandomState(3).rand(n) * 2.0).astype(np.float32)
    cap[::11] = 0.0
    ref = jct.trace_pallas_paged_dnf(j.clusters, j.pages, jnp.asarray(o),
                                     jnp.asarray(d), jnp.asarray(cap),
                                     interpret=True)[1] >= 0
    args = (t.clusters, t.pages, *(torch.as_tensor(a) for a in (o, d, cap)))
    occ = tct.occluded_paged_dnf(*args)
    np.testing.assert_array_equal(np.asarray(ref), occ.numpy())
    assert torch.equal(occ, tct.trace_paged_walk_torch(*args)[1] >= 0)
    assert 20 < int(occ.sum()) < n - 20


def test_paged_walk_never_visits_padding(scenes):
    """Poison every padding cluster so that it hits every ray at t = 0.5
    (u = v = 0 and a constant w row): the index-order sweep over the padded
    set then reports those hits, the paged walk none of them."""
    _, t = scenes["mesh"]
    o, d, t0 = _wave(t)
    n_pages, page_size, n_real = tct.page_shape(t.clusters, t.pages)
    pad = torch.ones(n_pages * page_size, dtype=torch.bool)
    for g, n in enumerate(n_real.tolist()):
        pad[g * page_size:g * page_size + n] = False
    assert bool(pad.any())
    woop = t.clusters.woop.clone()
    woop[pad] = 0.0
    woop[pad, 3, 2 * tcl.CLUSTER_SIZE:] = -5e-31      # t = 5e-31 / 1e-30
    poisoned = t.clusters._replace(woop=woop)
    flat = tct.trace_torch(poisoned, o, d, t0)
    assert bool((pad[flat[1][flat[1] >= 0].long()
                     // tcl.CLUSTER_SIZE]).any())
    assert bool((flat[0] == 0.5).any())
    clean = tct.trace_paged_walk_torch(t.clusters, t.pages, o, d, t0)
    for a, b in zip(clean, tct.trace_paged_walk_torch(poisoned, t.pages, o,
                                                      d, t0)):
        assert torch.equal(a, b)
    assert torch.equal(tct.occluded_paged_dnf(t.clusters, t.pages, o, d, t0),
                       clean[1] >= 0)


def test_paged_render_matches_jax(scenes):
    """A 24x24 render of the paged cornell_mesh(3) (depth 5 crosses the
    megakernel's compaction, which runs on paged scenes as in JAX)."""
    j, t = scenes["mesh"]
    kw = dict(width=24, height=24, samples_per_pixel=2, max_depth=5, seed=3,
              nee=True)
    cam = jscenes.CORNELL_CAMERA
    img_j = np.asarray(jprog.render_once(
        j, jcamera(cam, 1.0), JConfig(traversal="cluster_jax", **kw)))
    img_t = tprog.render_once(t, tcamera(cam, 1.0, device="cpu"),
                              TConfig(**kw)).numpy()
    assert img_t.shape == img_j.shape and np.isfinite(img_t).all()
    diff = np.abs(img_j - img_t).max(axis=-1)
    assert (diff > 1e-3).mean() <= 0.01
    assert abs(img_t.mean() - img_j.mean()) <= 0.01 * img_j.mean()
    assert img_t.mean() > 0.05
    assert 3 in tmega.COMPACT_DEPTHS
