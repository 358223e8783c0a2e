"""Two-level instancing (``ops.clusters.InstanceTree``): the route that
``SceneBuilder.build`` takes for static placements past
``DNF_MAX_CLUSTERS`` (the budget monkeypatched low here, as
tests/test_torch_tree.py does), its plain walks and its kernels.

On the CPU the plain two-level walks (``trace_inst_tree_torch``,
``occluded_inst_tree_torch``) are held against the instanced sweep over
the same placements expanded (``trace_inst_torch``,
``occluded_inst_torch``) on tiny fields: the closest hit's t bit for bit,
its slot, normal and material equal except where t ties (the contract the
flat and paged walks keep against ``trace_torch``); the any hit equal.
The build routes a field past the budget to the two-level structure
without expanding it; moving placements past the budget still raise; a
render equals the expanded route's image and engine counts, and its
``stats`` add the two-level walk's counts, which the plain walks' and
the kernels' counting launches agree on.

On the card (tests marked ``card``; they skip without one) both kernels
equal the plain walks bit for bit; the instanced sweep's kernels still
equal their plain versions. The suite's
``conftest.py`` imports JAX, which the machine with the card lacks, so
run them there with

    python -m pytest tests/test_torch_inst_tree.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from pathtracing_tpu_torch.models import megakernel
from pathtracing_tpu_torch.models import scene as scene_mod
from pathtracing_tpu_torch.models import scenes
from pathtracing_tpu_torch.ops import cluster_trace as ct
from pathtracing_tpu_torch.ops import clusters as cl_ops
from pathtracing_tpu_torch.ops.camera import build_camera
from pathtracing_tpu_torch.utils.config import CameraConfig, RenderConfig

torch.set_num_threads(2)

# (grid, squash range of y, of x and z, overrides): a field with its
# materials overridden, and one squashed anisotropically without overrides.
FIELDS = {"overrides": (5, (1.0, 1.0), (1.0, 1.0), True),
          "scaled": (4, (0.4, 1.8), (0.5, 1.3), False)}


def _build(case, device="cpu", motion=False):
    """The Cornell-like base (ground, light) under a grid of a 320-triangle
    icosphere, each placement turned about y, squashed and jittered."""
    grid, sy_range, sxz_range, overrides = FIELDS[case]
    rs = np.random.default_rng(grid)
    b = scene_mod.SceneBuilder()
    body = b.lambertian((0.7, 0.3, 0.25))
    rust = b.lambertian((0.8, 0.6, 0.3))
    sky = b.lambertian((0.25, 0.4, 0.65))
    ground = b.lambertian((0.6, 0.58, 0.52))
    light = b.emissive((40.0, 38.0, 34.0))
    b.add_quad((-6.0, 0.0, -6.0), (12.0, 0.0, 0.0), (0.0, 0.0, 12.0), ground)
    b.add_quad((-1.0, 5.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), light)
    ts, mats, moves = [], [], []
    half = 0.75 * (grid - 1)
    for i in range(grid):
        for j in range(grid):
            a = rs.uniform(0.0, 2.0 * np.pi)
            c, s = np.cos(a), np.sin(a)
            rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
            sy, sxz = rs.uniform(*sy_range), rs.uniform(*sxz_range)
            t = np.array([-half + 1.5 * i + rs.uniform(-0.3, 0.3), 0.45 * sy,
                          -half + 1.5 * j + rs.uniform(-0.3, 0.3)])
            ts.append(np.concatenate([rot @ np.diag([sxz, sy, sxz]),
                                      t[:, None]], axis=1))
            mats.append((None, rust, sky)[(i * grid + j) % 3]
                        if overrides else None)
            moves.append(ts[-1] + np.array([[0, 0, 0, 0.3]] * 3)
                         if motion else None)
    verts, faces = scenes.icosphere(2, 0.45)
    b.add_instances(verts, faces, body, ts, materials=mats,
                    motion_transforms=moves if motion else None)
    return b.build(device)


@pytest.fixture(scope="module")
def built():
    """{case: (expanded scene, two-level scene)} on the CPU: the same
    builder calls under the default budget and under a budget of 4."""
    out = {}
    for case in FIELDS:
        expanded = _build(case)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ct, "DNF_MAX_CLUSTERS", 4)
            out[case] = (expanded, _build(case))
    return out


def _rays(n, seed, device="cpu"):
    """Rays into the field from above and around it, every 11th lane
    dead."""
    g = torch.Generator().manual_seed(seed)
    a = torch.rand(n, generator=g) * 2.0 * np.pi
    o = torch.stack([7.0 * torch.cos(a), 1.0 + 5.0 * torch.rand(n, generator=g),
                     7.0 * torch.sin(a)], dim=1)
    target = (torch.rand(n, 3, generator=g) * torch.tensor([7.0, 1.2, 7.0])
              - torch.tensor([3.5, 0.0, 3.5]))
    d = target - o
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    t0 = torch.full((n,), 3.0e38)
    t0[::11] = 0.0
    return o.to(device), d.to(device), t0.to(device)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_contract(sweep, walk, t0):
    """t bit for bit; slot, normal and material equal except where t
    ties (each differing lane's t is another candidate's too: counted, and
    held rare)."""
    assert torch.equal(_bits(sweep[0]), _bits(walk[0]))
    same = sweep[1] == walk[1]
    live = t0 > 0
    assert int((~same & live).sum()) <= max(1, int(live.sum()) // 200)
    hit = same & (sweep[1] >= 0)
    assert int(hit.sum()) > 100
    assert torch.equal(_bits(sweep[2][hit]), _bits(walk[2][hit]))
    assert torch.equal(sweep[3][hit], walk[3][hit])
    assert torch.equal(sweep[3][~(sweep[1] >= 0)], walk[3][~(sweep[1] >= 0)])


@pytest.mark.parametrize("case", sorted(FIELDS))
def test_two_level_walks_meet_the_instanced_sweep(built, case):
    expanded, two = built[case]
    o, d, t0 = _rays(2500, 3)
    sweep = ct.trace_inst_torch(expanded.clusters, expanded.instances, o, d,
                                t0)
    walk = ct.trace_inst_tree_torch(two.clusters, two.inst_tree, o, d, t0)
    _assert_contract(sweep, walk, t0)
    if case == "overrides":
        hit = walk[1] >= 0
        assert {3, 1, 2} <= set(walk[3][hit].tolist())
    # Shadow caps short of, at and past the closest hit.
    cap = torch.where(t0 > 0, sweep[0].clamp(max=30.0), 0.0)
    for scale in (0.5, 1.0, 1.5):
        want = ct.occluded_inst_torch(expanded.clusters, expanded.instances,
                                      o, d, cap * scale)
        got = ct.occluded_inst_tree_torch(two.clusters, two.inst_tree, o, d,
                                          cap * scale)
        assert torch.equal(want, got)
    assert 0 < int(got.sum()) < int((cap > 0).sum())


def test_build_routes_past_the_budget_without_expanding(built, monkeypatch):
    """Past the budget nothing expands (``expand_instances`` refuses to
    run); one record per placement, the base geometry's first as an
    identity, over one tree per prototype."""
    expanded, two = built["overrides"]
    assert scene_mod.cluster_route(expanded) == "instanced"
    assert scene_mod.cluster_route(two) == "inst_tree"
    assert two.instances is None and scene_mod.uses_dnf(two)
    assert not scene_mod.has_motion(two)
    assert torch.equal(two.clusters.woop, expanded.clusters.woop)
    it = two.inst_tree
    assert it.xform.shape == (26, 12) and it.root.shape == (26,)
    assert torch.equal(it.xform[0], torch.tensor(
        [1.0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0]))
    assert it.root[0] == 0 and bool((it.root[1:] == it.root[1]).all())
    assert it.node_box.shape == (6, 2 * 26 - 1)
    n_base = int(it.root[1])
    n_proto = it.forest_box.shape[1] - n_base
    assert n_proto == 2 * (two.clusters.woop.shape[0] - 1) - 1
    leaves = it.forest_meta[1][it.forest_meta[1] >= 0]
    assert sorted(leaves.tolist()) == list(range(two.clusters.woop.shape[0]))
    assert torch.equal(it.imat, torch.tensor(
        [-1] + [(-1, 1, 2)[k % 3] for k in range(25)], dtype=torch.int32))
    # Every world box holds its placement's expanded boxes.
    inst = expanded.instances
    for p in range(26):
        rows = inst.inst_id == p
        assert bool((it.aabb_min[p] <= inst.aabb_min[rows]).all())
        assert bool((it.aabb_max[p] >= inst.aabb_max[rows]).all())

    def refuse(*a, **k):
        raise AssertionError("expanded past the budget")

    monkeypatch.setattr(cl_ops, "expand_instances", refuse)
    monkeypatch.setattr(ct, "DNF_MAX_CLUSTERS", 4)
    assert _build("scaled").inst_tree is not None


def test_moving_placements_past_the_budget_raise(monkeypatch):
    monkeypatch.setattr(ct, "DNF_MAX_CLUSTERS", 4)
    with pytest.raises(ValueError, match="exceed the DNF budget"):
        _build("scaled", motion=True)


def test_render_counts_the_walks_and_equals_the_expanded_route(built):
    """A small megakernel render of each structure: the same image bit for
    bit, and the same ``stats`` of rays entering the closest-hit and the
    shadow queries: the route changes neither what is traced nor what
    the engine counts. The two-level route also counts its walks
    (``placements_entered``, ``proto_clusters_tested``)."""
    expanded, two = built["overrides"]
    cfg = RenderConfig(width=12, height=10, samples_per_pixel=1,
                       max_depth=3, seed=5, nee=True)
    cam = build_camera(CameraConfig(position=(0.0, 6.0, 8.0),
                                    look_at=(0.0, 0.0, 0.0),
                                    vfov_degrees=50.0), 1.2, device="cpu")
    images, stats = [], []
    for scene in (expanded, two):
        st = {}
        images.append(megakernel.render_samples(scene, cam, cfg, 0, 1, 5,
                                                stats=st))
        stats.append(st)
    assert torch.equal(images[0], images[1])
    assert float(images[1].sum()) > 0.0
    assert set(stats[0]) == {"segments", "shadow_segments"}
    assert set(stats[1]) == set(stats[0]) | set(ct.WALK_COUNTS)
    for key in stats[0]:
        assert int(stats[0][key]) == int(stats[1][key]) > 0
    for key in ct.WALK_COUNTS:
        assert int(stats[1][key]) > 0


def test_plain_stats_count_entries_and_evaluations(built):
    _, two = built["scaled"]
    o, d, t0 = _rays(400, 7)
    st = {}
    counts = ct.walk_counts("cpu")
    ct.trace_inst_tree_torch(two.clusters, two.inst_tree, o, d, t0, stats=st,
                             counts=counts)
    assert st["cluster_evals"] == st["proto_clusters_tested"] > 0
    assert st["slab_tests"] > st["placements_entered"] > 0
    assert counts.tolist() == [st[k] for k in ct.WALK_COUNTS]
    # The counter adds up across queries, as the engine's frames use it.
    ct.occluded_inst_tree(two.clusters, two.inst_tree, o, d, t0 * 0.5,
                          counts=counts)
    after = dict(zip(ct.WALK_COUNTS, counts.tolist()))
    assert all(after[k] > st[k] for k in ct.WALK_COUNTS)


def test_wrappers_refuse_other_devices(built):
    """Rays on neither the CPU nor a CUDA device (``meta``) raise: the
    wrappers take the plain walks only for CPU tensors."""
    _, two = built["scaled"]
    o = torch.zeros((4, 3), device="meta")
    t = torch.ones(4, device="meta")
    before = dict(ct.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        ct.trace_inst_tree(two.clusters, two.inst_tree, o, o, t)
    with pytest.raises(ValueError, match="CUDA"):
        ct.occluded_inst_tree(two.clusters, two.inst_tree, o, o, t)
    assert ct.LAUNCHES == before


# --- On the card ------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the two-level kernels run only on the "
                    "card (CUDA C++, no interpret mode)")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(FIELDS))
def test_kernels_equal_the_plain_walks_on_the_card(card, case):
    expanded = _build(case, device=card)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ct, "DNF_MAX_CLUSTERS", 4)
        two = _build(case, device=card)
    o, d, t0 = _rays(20011, 5, card)
    want = ct.trace_inst_tree_torch(two.clusters, two.inst_tree, o, d, t0)
    got = ct.trace_inst_tree(two.clusters, two.inst_tree, o, d, t0)
    for w, g in zip(want, got):
        assert torch.equal(_bits(w), _bits(g))
    cap = torch.where(t0 > 0, want[0].clamp(max=30.0), 0.0) * 1.5
    occ = ct.occluded_inst_tree_torch(two.clusters, two.inst_tree, o, d, cap)
    assert torch.equal(occ, ct.occluded_inst_tree(two.clusters,
                                                  two.inst_tree, o, d, cap))
    # The counting launches: the same answers, and the plain walks' counts.
    for query, plain, kernel, arg in (
            ("trace", ct.trace_inst_tree_torch, ct.trace_inst_tree, t0),
            ("occluded", ct.occluded_inst_tree_torch, ct.occluded_inst_tree,
             cap)):
        c_plain, c_kernel = ct.walk_counts(card), ct.walk_counts(card)
        a = plain(two.clusters, two.inst_tree, o, d, arg, counts=c_plain)
        b = kernel(two.clusters, two.inst_tree, o, d, arg, counts=c_kernel)
        for w, g in zip(*((a, b) if query == "trace" else ((a,), (b,)))):
            assert torch.equal(_bits(w), _bits(g)), query
        assert c_kernel.tolist() == c_plain.tolist(), query
        assert min(c_plain.tolist()) > 0, query
    # The instanced sweep's kernels on the same rays, expanded.
    sweep = ct.trace_inst_torch(expanded.clusters, expanded.instances, o, d,
                                t0)
    for w, g in zip(sweep, ct.trace_inst(expanded.clusters,
                                         expanded.instances, o, d, t0)):
        assert torch.equal(_bits(w), _bits(g))
    assert torch.equal(
        ct.occluded_inst_torch(expanded.clusters, expanded.instances, o, d,
                               cap),
        ct.occluded_inst(expanded.clusters, expanded.instances, o, d, cap))
    _assert_contract(sweep, want, t0)


@pytest.mark.card
def test_walker_kernels_still_equal_their_plain_walks(card):
    """The walker's other kernels, after the level policy joined it: rows
    1-2 (the flat pair), 6 (the paged pair) and 7 (the tree walk) bit for
    bit against their plain walks on cornell_mesh(5) (20,480 triangles,
    paged by 64 for row 6)."""
    flat = scenes.cornell_mesh_builder(5).build(card)
    paged = scenes.cornell_mesh_builder(5).build(card, page_clusters=64)
    assert paged.pages is not None
    g = torch.Generator().manual_seed(9)
    n = 30011
    o = (torch.rand(n, 3, generator=g) * 1.6 - 0.8).to(card)
    d = torch.randn(n, 3, generator=g)
    d = (d / torch.linalg.norm(d, dim=1, keepdim=True)).to(card)
    t0 = torch.full((n,), 3.0e38, device=card)
    t0[::11] = 0.0
    cap = torch.where(t0 > 0, torch.rand(n, generator=g).to(card) * 2.0,
                      0.0)
    c, p = flat.clusters, paged.pages
    pairs = [
        (ct.trace(c, o, d, t0), ct.trace_flat_walk_torch(c, o, d, t0)),
        (ct.occluded(c, o, d, cap), ct.occluded_tree_torch(c, o, d, cap)),
        (ct.trace_tree(c, o, d, t0), ct.trace_tree_torch(c, o, d, t0)),
        (ct.trace_paged_dnf(paged.clusters, p, o, d, t0),
         ct.trace_paged_walk_torch(paged.clusters, p, o, d, t0)),
        (ct.occluded_paged_dnf(paged.clusters, p, o, d, cap),
         ct.occluded_paged_dnf_torch(paged.clusters, p, o, d, cap)),
    ]
    for got, want in pairs:
        for x, y in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(_bits(x), _bits(y))
