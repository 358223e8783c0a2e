"""Port parity for the cluster-tree walks and the host BVH builder.

(a) The plain per-ray walks of the port (``trace_tree_torch``,
    ``occluded_tree_torch``, ``trace_tree_paged_torch``) agree with the JAX
    package's ``trace_pallas``, ``occluded_pallas`` and
    ``trace_pallas_paged`` in interpret mode, at their default variants,
    under the tie contract of tests/test_clusters.py:118-145: t within
    rtol 1e-6 on live lanes (1e-5 for the soup, as in
    tests/test_torch_clusters.py), slot equal or t tied, normals within
    1e-4 and materials equal where the slots agree, dead lanes ignored;
    occlusion equal. Inside the port, the any-hit walk equals the capped
    closest-hit sweep exactly, and the per-page walk in its kernel's
    order (pages nearest first, ``trace_tree_paged_walk_torch``) gives the
    page-order walk's t bit for bit, its slot or a tied t, and the paged
    walk's (``trace_paged_walk_torch``) t, slot and material bit for bit.
(b) An unpaged scene past ``DNF_MAX_CLUSTERS`` (the budget monkeypatched
    low in both packages' modules, test only) routes to the tree walk in
    both packages with the same hits, and renders as the JAX package does.
(c) The port's C++ BVH builder gives the NumPy builder's bytes, and the
    earlier slices' scenes build byte-equal tables with either; a builder
    that cannot be built raises.
"""

import chip_smoke
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
from pathtracing_tpu_torch.models import progressive as tprog
from pathtracing_tpu_torch.models import scene as tscene_mod
from pathtracing_tpu_torch.models import scenes as tscenes
from pathtracing_tpu_torch.ops import bvh as tbvh
from pathtracing_tpu_torch.ops import cluster_trace as tct
from pathtracing_tpu_torch.ops import clusters as tcl
from pathtracing_tpu_torch.ops import cuda_build
from pathtracing_tpu_torch.ops.camera import build_camera as tcamera
from pathtracing_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(2)

RTOL = {"mesh": 1e-6, "soup": 1e-5}


def _soup_tris(n=333, seed=42):
    """The triangles of tests/test_clusters.py's soup, as (v0, e1, e2,
    mat) float32 arrays."""
    rs = np.random.RandomState(seed)
    v = np.stack([rs.randn(3) * 1.5 + rs.randn(3, 3) * 0.25
                  for _ in range(n)]).astype(np.float32)
    mat = (np.arange(n) % 2).astype(np.int32)
    return v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], mat


def _mesh_tris():
    verts, faces = tscenes.icosphere(3, 0.5)
    v = verts[faces].astype(np.float32)
    mat = np.ones(v.shape[0], np.int32)
    return v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], mat


TRIS = {"mesh": _mesh_tris, "soup": _soup_tris}


def _to_torch(tup, cls):
    return cls(**{f: None if getattr(tup, f, None) is None
                  else torch.as_tensor(np.asarray(getattr(tup, f)))
                  for f in cls._fields})


@pytest.fixture(scope="module")
def sets():
    """{name: (JAX numpy ClusterSet, the same as the port's tensors)}."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bvh_native, "build", lambda *a, **k: None)
        for name, tris in TRIS.items():
            cs = jcl.build_clusters(*tris())[0]
            out[name] = (cs, _to_torch(cs, tcl.ClusterSet))
    return out


@pytest.fixture(scope="module")
def paged():
    """The paged cornell_mesh(3) (page size 4) of both packages."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bvh_native, "build", lambda *a, **k: None)
        mp.setattr(tbvh, "USE_NATIVE", False)
        j = jscenes._cornell_mesh_builder(3).build(page_clusters=4)
        t = tscenes.cornell_mesh_builder(3).build("cpu", page_clusters=4)
    assert t.pages.node_box.shape[0] >= 3
    return j, t


def _rays(n, seed, name="mesh"):
    rs = np.random.RandomState(seed)
    center, spread = {"mesh": ((0.0, 0.0, 1.6), 0.3),
                      "soup": ((0.0, 0.0, 4.0), 1.5)}[name]
    o = np.repeat([center], n, 0) + rs.randn(n, 3) * spread
    d = rs.randn(n, 3)
    d[:, 2] -= 1.0                      # mostly toward the geometry
    d[::13, 0] = 0.0                    # zero components count as negative
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t0 = np.full(n, 3.0e38, np.float32)
    t0[::11] = 0.0                      # dead lanes
    return o.astype(np.float32), d.astype(np.float32), t0


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tie_contract(ref, new, live, rtol):
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


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


# --- (a) the walks against the JAX kernels --------------------------------


@pytest.mark.parametrize("name", sorted(TRIS))
def test_trace_tree_torch_matches_trace_pallas(sets, name):
    cs, ct = sets[name]
    o, d, t0 = _rays(601, 2, name)
    ref = jct.trace_pallas(cs, *_jax(o, d, t0), interpret=True)
    new = tct.trace_tree(ct, *(torch.as_tensor(a) for a in (o, d, t0)))
    _assert_tie_contract(ref, new, t0 > 0, RTOL[name])


@pytest.mark.parametrize("name", sorted(TRIS))
def test_occluded_tree_torch_matches_occluded_pallas(sets, name):
    cs, ct = sets[name]
    o, d, _ = _rays(601, 3, name)
    cap = (np.random.RandomState(5).rand(601) * 3.0).astype(np.float32)
    cap[::7] = 0.0
    ref = np.asarray(jct.occluded_pallas(cs, *_jax(o, d, cap),
                                         interpret=True))
    new = tct.occluded_tree(ct, *(torch.as_tensor(a) for a in (o, d, cap)))
    np.testing.assert_array_equal(ref, new.numpy())
    assert 20 < ref.sum() < 580


@pytest.mark.parametrize("name", sorted(TRIS))
def test_occluded_tree_equals_capped_trace(sets, name):
    _, ct = sets[name]
    o, d, _ = (torch.as_tensor(a) for a in _rays(999, 6, name))
    cap = torch.as_tensor(
        (np.random.RandomState(6).rand(999) * 4.0).astype(np.float32))
    cap[::9] = 0.0
    ref = tct.trace_torch(ct, o, d, cap)[1] >= 0
    assert torch.equal(tct.occluded_tree_torch(ct, o, d, cap), ref)


@pytest.mark.parametrize("name", sorted(TRIS))
def test_trace_tree_torch_matches_flat_sweep(sets, name):
    """Same hits as the index-order sweep of the port (the visit order
    differs, so only the tie contract holds), fewer cluster evaluations."""
    _, ct = sets[name]
    o, d, t0 = (torch.as_tensor(a) for a in _rays(999, 7, name))
    flat, walk = {}, {}
    ref = tct.trace_torch(ct, o, d, t0, stats=flat)
    new = tct.trace_tree_torch(ct, o, d, t0, stats=walk)
    _assert_tie_contract(ref, new, (t0 > 0).numpy(), 1e-6)
    assert 0 < walk["cluster_evals"] <= flat["cluster_evals"]


@pytest.mark.parametrize("name", sorted(TRIS))
def test_flat_walk_is_the_tree_walk_with_table_normals(sets, name):
    """The flat closest hit's plain version and the tree walk share one
    walk: the same t, slot, material and evaluations; only the normal's
    source differs (the table against the winner's Woop w-row)."""
    _, ct = sets[name]
    o, d, t0 = (torch.as_tensor(a) for a in _rays(603, 10, name))
    fs, ts = {}, {}
    flat = tct.trace_flat_walk_torch(ct, o, d, t0, stats=fs)
    tree = tct.trace_tree_torch(ct, o, d, t0, stats=ts)
    for k in (0, 1, 3):
        assert torch.equal(flat[k], tree[k])
    assert fs == ts and fs["cluster_evals"] > 0
    hit = flat[1] >= 0
    assert torch.equal(flat[2][hit], tct.lookup_hit(ct, flat[1])[0][hit])
    assert torch.allclose(flat[2], tree[2], atol=1e-5)


def test_trace_tree_paged_torch_matches_trace_pallas_paged(paged):
    j, t = paged
    o, d, t0 = _rays(601, 4)
    ref = jct.trace_pallas_paged(j.clusters, j.pages, *_jax(o, d, t0),
                                 interpret=True)
    new = tct.trace_tree_paged(t.clusters, t.pages,
                               *(torch.as_tensor(a) for a in (o, d, t0)))
    _assert_tie_contract(ref, new, t0 > 0, 1e-6)


def _capped_waves(n, seed):
    """A closest-hit wave of ``n`` rays (every 11th lane dead) and the same
    rays capped at t = 1.5, the capped lanes' pages cut short."""
    o, d, t0 = (torch.as_tensor(a) for a in _rays(n, seed))
    return [(o, d, t0), (o, d, torch.where(t0 > 0, 1.5, 0.0))]


@pytest.mark.parametrize("wave", ["closest", "capped"])
def test_tree_paged_walk_matches_page_order_walk(paged, wave):
    """The per-page walk in its kernel's order (pages nearest first)
    against the page-order oracle ``trace_tree_paged_torch``, on 601 rays
    (not a multiple of the warp) with dead lanes: t bit for bit, slot equal
    or t tied, normal (the Woop w-row) and material bit for bit where the
    slots agree. The fixture's page trees have more nodes than its pages
    have clusters: the kernel's C interface takes (n_pages, page_nodes,
    page_size) and its walker (n_pages, page_size, page_nodes)."""
    _, t = paged
    _, page_size, _ = tct.page_shape(t.clusters, t.pages)
    assert t.pages.node_box.shape[2] != page_size
    o, d, cap = _capped_waves(601, 13)[["closest", "capped"].index(wave)]
    ref = tct.trace_tree_paged_torch(t.clusters, t.pages, o, d, cap)
    new = tct.trace_tree_paged_walk_torch(t.clusters, t.pages, o, d, cap)
    assert torch.equal(ref[0], new[0])
    same = ref[1] == new[1]
    assert bool((same | (ref[0] == new[0])).all())
    assert int((same & (ref[1] >= 0)).sum()) > 20
    assert torch.equal(ref[2][same], new[2][same])
    assert torch.equal(ref[3][same], new[3][same])
    assert bool((new[1][cap <= 0] == -1).all())
    assert torch.equal(new[0][cap <= 0], cap[cap <= 0])


def test_tree_paged_walk_is_the_paged_walk_with_woop_normals(paged):
    """Row 9's plain version and row 6's share one walk: the same t, slot,
    material and work; only the normal's source differs (the winner's Woop
    w-row against the table)."""
    _, t = paged
    for o, d, cap in _capped_waves(601, 14):
        ws, ps = {}, {}
        tree = tct.trace_tree_paged_walk_torch(t.clusters, t.pages, o, d,
                                               cap, stats=ws)
        flat = tct.trace_paged_walk_torch(t.clusters, t.pages, o, d, cap,
                                          stats=ps)
        for k in (0, 1, 3):
            assert torch.equal(tree[k], flat[k])
        assert ws == ps and ws["cluster_evals"] > 0
        hit = tree[1] >= 0
        woop_hit = tct._woop_normal_hit(t.clusters, tree[0], tree[1])
        assert torch.equal(tree[2], woop_hit[2])
        assert torch.allclose(tree[2][hit], flat[2][hit], atol=1e-5)


def test_tree_paged_wrapper_takes_the_nearest_first_walk(paged):
    """``trace_tree_paged`` on CPU tensors is ``trace_tree_paged_walk_torch``
    bit for bit and launches nothing."""
    _, t = paged
    o, d, t0 = _capped_waves(333, 15)[0]
    before = dict(tct.LAUNCHES)
    got = tct.trace_tree_paged(t.clusters, t.pages, o, d, t0)
    assert tct.LAUNCHES == before
    for a, b in zip(got, tct.trace_tree_paged_walk_torch(t.clusters, t.pages,
                                                         o, d, t0)):
        assert torch.equal(a, b)


def test_tree_walks_accept_a_paged_flat_set(paged):
    """The flat set of a paged scene keeps a global tree over the real
    clusters in page order: the whole-tree walk and the per-page walks
    find the paged sweep's hits."""
    _, t = paged
    o, d, t0 = (torch.as_tensor(a) for a in _rays(801, 9))
    ref = tct.trace_paged_dnf(t.clusters, t.pages, o, d, t0)
    live = (t0 > 0).numpy()
    _assert_tie_contract(ref, tct.trace_tree(t.clusters, o, d, t0), live,
                         1e-6)
    _assert_tie_contract(ref, tct.trace_tree_paged(t.clusters, t.pages, o, d,
                                                   t0), live, 1e-6)


@pytest.mark.parametrize("name", [
    "trace_torch", "trace_flat_walk_torch", "trace_paged_dnf_torch",
    "trace_paged_walk_torch", "trace_tree_torch", "trace_tree_paged_torch",
    "trace_tree_paged_walk_torch", "occluded_torch",
    "occluded_paged_dnf_torch", "occluded_tree_torch"])
def test_needed_evals_bounds_every_visiting_order(paged, name):
    """``chip_smoke.needed_evals``, the count behind the traversal kernels'
    bound, equals a per-cluster count with the plain versions' own slab
    test against the final t, at least one for a ray that hit (an any-hit
    query: against the cap for unoccluded rays, one for an occluded ray),
    and no plain version, whatever order it visits the clusters in,
    evaluates fewer."""
    _, t = paged
    cl = t.clusters
    o, d, t0 = (torch.as_tensor(a) for a in _rays(501, 12))
    any_hit = name.startswith("occluded")
    if any_hit:
        caps = np.random.RandomState(3).rand(501).astype(np.float32) * 2.0
        t0 = torch.where(t0 > 0, torch.as_tensor(caps), t0)
    args = (cl, t.pages) if "paged" in name else (cl,)
    stats = {}
    out = getattr(tct, name)(*args, o, d, t0, stats=stats)
    real = (cl.aabb_min <= cl.aabb_max).all(dim=1)
    assert not bool(real.all())              # the set carries padding
    bmin, bmax = cl.aabb_min[real], cl.aabb_max[real]
    live = t0 > 0
    if any_hit:
        needed = chip_smoke.needed_evals(bmin, bmax, (o, d, t0), t0,
                                         occluded=out, chunk_elems=1000)
        cap, loop, live = t0, int((live & out).sum()), live & ~out
        assert 0 < int(out.sum()) < int((t0 > 0).sum())
    else:
        needed = chip_smoke.needed_evals(bmin, bmax, (o, d, t0), out[0],
                                         chunk_elems=1000)
        cap, loop = out[0], 0
    inv_d = tct._safe_inv(d)
    per_ray = torch.zeros(o.shape[0], dtype=torch.int64)
    for c in range(bmin.shape[0]):
        per_ray += live & tct._slab(o, inv_d, bmin[c], bmax[c], cap)
    if not any_hit:
        hit = live & (out[1] >= 0)
        per_ray = torch.where(hit, torch.clamp(per_ray, min=1), per_ray)
        assert needed >= int(hit.sum()) > 0     # each hit needs its winner
    assert needed == loop + int(per_ray.sum())
    assert 0 < needed <= stats["cluster_evals"]


def test_needed_evals_counts_the_winner_on_a_flat_wall():
    """A ray that hits an axis-aligned quad reaches its cluster's flat box
    only at its final t, so the pierced-before-t count alone is 0 there:
    each ray that hit still needs its winner evaluated."""
    v0 = np.array([[-1, -1, 0], [1, 1, 0]], np.float32)
    e1 = np.array([[2, 0, 0], [-2, 0, 0]], np.float32)
    e2 = np.array([[0, 2, 0], [0, -2, 0]], np.float32)
    cl = tcl.ClusterSet(*(None if a is None else torch.as_tensor(a) for a in
                          tcl.build_clusters(v0, e1, e2,
                                             np.zeros(2, np.int32))[0]))
    assert bool((cl.aabb_min[0, 2] == cl.aabb_max[0, 2]))   # a flat box
    rs = np.random.RandomState(4)
    o = torch.as_tensor(np.c_[rs.uniform(-1.5, 1.5, (300, 2)),
                              np.ones(300)].astype(np.float32))
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(300, 1)
    t0 = torch.full((300,), 3.0e38)
    t0[::11] = 0.0
    out = tct.trace_torch(cl, o, d, t0)
    hit = (t0 > 0) & (out[1] >= 0)
    assert 0 < int(hit.sum()) < int((t0 > 0).sum())
    assert bool((out[0][hit] == 1.0).all())
    inv_d = tct._safe_inv(d)
    assert not bool(tct._slab(o, inv_d, cl.aabb_min[0], cl.aabb_max[0],
                              out[0])[hit].any())
    assert chip_smoke.needed_evals(cl.aabb_min, cl.aabb_max, (o, d, t0),
                                   out[0]) == int(hit.sum())


def test_tree_wrappers_refuse_other_devices(sets):
    _, ct = sets["mesh"]
    cl = tcl.ClusterSet(*(x.to("meta") for x in ct))
    o = torch.zeros((4, 3), device="meta")
    t = torch.ones(4, device="meta")
    before = dict(tct.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tct.trace_tree(cl, o, o, t)
    with pytest.raises(ValueError, match="CUDA"):
        tct.occluded_tree(cl, o, o, t)
    assert tct.LAUNCHES == before


def test_tree_walk_refuses_a_set_without_tree(sets):
    _, ct = sets["mesh"]
    bare = ct._replace(node_box=None, node_meta=None, oct_links=None)
    o, d, t0 = (torch.as_tensor(a) for a in _rays(8, 1))
    with pytest.raises(ValueError, match="no cluster tree"):
        tct.trace_tree(bare, o, d, t0)


# --- (b) routing past the budget ------------------------------------------


@pytest.fixture
def small_budget(monkeypatch):
    """Both packages' flat-kernel budget cut to 4 clusters (the scenes are
    built before, unpaged)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bvh_native, "build", lambda *a, **k: None)
        mp.setattr(tbvh, "USE_NATIVE", False)
        j, _ = jscenes.cornell_mesh(3)
        t, _ = tscenes.cornell_mesh(3, device="cpu")
    assert t.pages is None and t.clusters.woop.shape[0] > 4
    monkeypatch.setattr(jct, "DNF_MAX_CLUSTERS", 4)
    monkeypatch.setattr(tct, "DNF_MAX_CLUSTERS", 4)
    return j, t


def test_unpaged_scene_past_budget_routes_to_tree(small_budget):
    j, t = small_budget
    assert not jscene_mod.uses_dnf(j) and not tscene_mod.uses_dnf(t)
    assert tscene_mod.cluster_route(t) == "tree"
    o, d, t0 = _rays(701, 8)
    active = t0 > 0
    hj = jscene_mod.intersect_batch(j, *_jax(o, d), "cluster_interpret",
                                    active=jnp.asarray(active))
    before = dict(tct.LAUNCHES)
    ht = tscene_mod.intersect_batch(t, torch.as_tensor(o),
                                    torch.as_tensor(d), "cluster_cuda",
                                    active=torch.as_tensor(active))
    assert tct.LAUNCHES == before           # CPU tensors launch nothing
    _assert_tie_contract((hj.t, hj.slot, hj.normal, hj.mat_id),
                         (ht.t, ht.slot, ht.normal, ht.mat_id), active, 1e-6)
    t_max = (np.random.RandomState(2).rand(701) * 3.0).astype(np.float32)
    oj = jscene_mod.occluded_batch(j, *_jax(o, d, t_max),
                                   "cluster_interpret",
                                   active=jnp.asarray(active))
    ot = tscene_mod.occluded_batch(t, *(torch.as_tensor(a)
                                        for a in (o, d, t_max)),
                                   "cluster_torch",
                                   active=torch.as_tensor(active))
    np.testing.assert_array_equal(np.asarray(oj), ot.numpy())


def test_tree_route_render_matches_jax(small_budget):
    """The megakernel does not compact on the tree route (``uses_dnf`` is
    False, as in JAX); the render equals the JAX render within the render
    tolerance of tests/test_torch_render.py."""
    j, t = small_budget
    kw = dict(width=16, height=16, samples_per_pixel=2, max_depth=4, seed=2,
              nee=True)
    cam = jscenes.CORNELL_CAMERA
    img_j = np.asarray(jprog.render_once(
        j, jcamera(cam, 1.0), JConfig(traversal="cluster_jax", **kw)))
    img_t = tprog.render_once(t, tcamera(cam, 1.0, device="cpu"),
                              TConfig(**kw)).numpy()
    diff = np.abs(img_j - img_t).max(axis=-1)
    assert (diff > 1e-3).mean() <= 0.01
    assert abs(img_t.mean() - img_j.mean()) <= 0.01 * img_j.mean()
    assert img_t.mean() > 0.05


# --- (c) the host BVH builder ---------------------------------------------


@pytest.mark.parametrize("name", sorted(TRIS))
@pytest.mark.parametrize("leaf", [4, 128])
def test_native_bvh_equals_numpy(name, leaf):
    v0, e1, e2, _ = TRIS[name]()
    (nmin, nmax, nmeta), perm = tbvh.bvh_native.build(v0, e1, e2, leaf,
                                                      tbvh.SAH_BINS)
    (rmin, rmax, rmeta), rperm = tbvh._build_bvh_numpy(v0, e1, e2, leaf)
    for a, b in ((nmin, rmin), (nmax, rmax), (nmeta, rmeta), (perm, rperm)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


SCENES = {
    "cornell_mesh(6)": lambda: tscenes.cornell_mesh(6, device="cpu")[0],
    "instanced_demo": lambda: tscenes.instanced_demo(device="cpu")[0],
    "many_lights_demo": lambda: tscenes.many_lights_demo(device="cpu")[0],
}


def _tensors(x, prefix=""):
    out = {}
    for k, v in x._asdict().items():
        if isinstance(v, torch.Tensor):
            out[prefix + k] = v.numpy().tobytes()
        elif hasattr(v, "_asdict"):
            out.update(_tensors(v, prefix + k + "."))
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_tables_equal_with_either_builder(name, monkeypatch):
    """The earlier slices' scenes: every table byte-equal whether the C++
    or the NumPy builder orders the triangles and packs the clusters."""
    native = _tensors(SCENES[name]())
    monkeypatch.setattr(tbvh, "USE_NATIVE", False)
    ref = _tensors(SCENES[name]())
    assert native.keys() == ref.keys()
    assert [k for k in ref if native[k] != ref[k]] == []


def test_native_builder_raises_when_it_cannot_be_built(monkeypatch):
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setattr(cuda_build, "HOST_FLAGS",
                        cuda_build.HOST_FLAGS + ("-DPTPU_BROKEN", "-include",
                                                 "no_such_header.h"))
    v0, e1, e2, _ = _soup_tris(8)
    with pytest.raises(RuntimeError, match="failed for csrc/bvh_builder"):
        tbvh.build_bvh(v0, e1, e2)
