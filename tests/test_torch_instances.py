"""Port parity for shared-geometry instancing: ``expand_instances``, the
instanced traversal's plain versions, the scene routes, the guards of
``SceneBuilder`` and the whole instanced render, fed the same numpy inputs
in both packages.

Tolerances and why:
  * ``expand_instances`` tables and ``SceneBuilder``'s instanced tables:
    byte equal (the same numpy code);
  * shutter-time draws: exact (the RNG is bit-exact);
  * instanced traversal against ``trace_jax_inst`` and against the Pallas
    kernels in interpret mode: the tie contract of
    tests/test_clusters.py:118-145 — t within rtol 1e-6 on live lanes
    (XLA:CPU contracts multiply-adds inside its jitted sweep, torch eager
    does not; 1e-5 with motion, whose per-ray 3×3 inverse adds a dozen
    more roundings to every transformed ray: one ray of 301 measured
    1.14e-6), slot equal or t tied,
    normals within 1e-4 and materials equal where the slots agree, dead
    lanes ignored; occlusion equal except where t sits within that
    tolerance of the cap;
  * inside the port (identity instance ≡ flat mesh, any-hit ≡ capped
    closest hit): bitwise;
  * renders: ≤ 1% of pixels over 1e-3, means within 1% (the render
    tolerance of tests/test_torch_render.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.models import progressive as jprog
from pathtracing_tpu.models import scene as jscene_mod
from pathtracing_tpu.models import scenes as jscenes
from pathtracing_tpu.ops import cluster_trace as jct
from pathtracing_tpu.ops import clusters as jcl
from pathtracing_tpu.ops import rng as jrng
from pathtracing_tpu.ops.camera import build_camera as jcamera
from pathtracing_tpu.utils.config import RenderConfig as JConfig
from pathtracing_tpu_torch.models import megakernel as tmega
from pathtracing_tpu_torch.models import progressive as tprog
from pathtracing_tpu_torch.models import scene as tscene_mod
from pathtracing_tpu_torch.models import scenes as tscenes
from pathtracing_tpu_torch.ops import cluster_trace as tct
from pathtracing_tpu_torch.ops import clusters as tcl
from pathtracing_tpu_torch.ops import rng as trng
from pathtracing_tpu_torch.ops.camera import build_camera as tcamera
from pathtracing_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(2)

EYE = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _proto(n=300, seed=0):
    rs = np.random.default_rng(seed)
    v0 = rs.uniform(-1, 1, (n, 3))
    e1 = rs.uniform(-0.3, 0.3, (n, 3))
    e2 = rs.uniform(-0.3, 0.3, (n, 3))
    mat = rs.integers(0, 4, n).astype(np.int32)
    return jcl.build_clusters(v0, e1, e2, mat)[0]


def _placements(nc, k, variant):
    """k placements of the whole prototype (tests/test_instances.py's
    field). ``variant``: "static", "imat" (two overrides) or "motion" (a
    shutter-close transform on every other instance)."""
    out = []
    for i in range(k):
        a = _rot_y(0.37 * i) @ np.diag([1.0 + 0.1 * (i % 4), 0.8, 1.2])
        t = np.array([2.5 * (i % 8) - 8.0, 0.2 * i, 3.0 + 2.0 * (i // 8)])
        m = np.concatenate([a, t[:, None]], axis=1)
        if variant == "static":
            out.append((0, nc, m))
        elif variant == "imat":
            out.append((0, nc, m, 10 + i if i in (1, 3) else -1))
        else:
            m1 = None
            if i % 2 == 0:
                a1 = _rot_y(0.37 * i + 0.3) @ np.diag([1.1, 0.9, 1.2])
                m1 = np.concatenate(
                    [a1, (t + [0.6, 0.2, -0.4])[:, None]], axis=1)
            out.append((0, nc, m, 7 if i == 2 else -1, m1))
    return out


def _rays(r, seed=1):
    rs = np.random.default_rng(seed)
    o = np.tile([0.0, 0.0, -12.0], (r, 1)) + rs.uniform(-1, 1, (r, 3))
    tgt = rs.uniform(-9, 9, (r, 3)) * [1, 0.25, 0.4] + [0, 0, 5.0]
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _t0(n, value=3.0e38):
    t0 = np.full(n, value, np.float32)
    t0[::11] = 0.0          # dead lanes
    return t0


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# The port's own InstanceSet fields: each placement's run and box.
PLACEMENT_FIELDS = ("inst_first", "inst_min", "inst_max")


def _to_torch(tup):
    """A numpy ClusterSet / InstanceSet of the JAX package as the port's
    NamedTuple of CPU tensors (by field name: the JAX ClusterSet also
    carries the tree fields only the TPU kernels read; the port's
    InstanceSet adds the placement fields, computed here as
    ``scene_from_numpy`` computes them)."""
    if hasattr(tup, "cmap"):
        cls, own = tcl.InstanceSet, dict(zip(PLACEMENT_FIELDS,
                                             tcl.placement_boxes(
                                                 np.asarray(tup.inst_id),
                                                 np.asarray(tup.aabb_min),
                                                 np.asarray(tup.aabb_max))))
    else:
        cls, own = tcl.ClusterSet, {}
    fields = {f: own[f] if f in own else getattr(tup, f)
              for f in cls._fields}
    return cls(**{f: None if x is None else torch.as_tensor(np.asarray(x))
                  for f, x in fields.items()})


def _to_jax(tup):
    return jax.tree.map(jnp.asarray, tup)


@pytest.fixture(scope="module")
def field():
    """{variant: (ClusterSet, InstanceSet)} as numpy, 5 instances."""
    cl = _proto()
    nc = cl.aabb_min.shape[0]
    return {v: (cl, jcl.expand_instances(cl, _placements(nc, 5, v)))
            for v in ("static", "imat", "motion")}


def _assert_tables_equal(a, b):
    """Every field of ``a`` byte equal in ``b``. ``b`` has ``a``'s fields;
    the port's InstanceSet against the JAX package's adds the placement
    fields (checked by the placement tests below)."""
    extra = (PLACEMENT_FIELDS if type(b) is tcl.InstanceSet
             and type(a) is not tcl.InstanceSet else ())
    assert type(b)._fields == type(a)._fields + extra
    for f in type(a)._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        x, y = _np(x), _np(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("variant", ["static", "imat", "motion"])
def test_expand_instances_tables_byte_equal(field, variant):
    cl, ref = field[variant]
    nc = cl.aabb_min.shape[0]
    new = tcl.expand_instances(
        tcl.ClusterSet(**{f: getattr(cl, f) for f in tcl.ClusterSet._fields}),
        _placements(nc, 5, variant))
    _assert_tables_equal(ref, new)
    assert (new.imat is None) == (variant == "static")
    assert (new.fw0 is None) == (variant != "motion")


def test_expand_instances_refuses_bad_transforms(field):
    cl, _ = field["static"]
    with pytest.raises(ValueError, match=r"\(3,4\) or \(4,4\)"):
        tcl.expand_instances(cl, [(0, 1, np.eye(2))])
    sing = np.concatenate([np.zeros((3, 3)), np.ones((3, 1))], axis=1)
    with pytest.raises(ValueError, match="singular"):
        tcl.expand_instances(cl, [(0, 1, EYE, -1, sing)])


def _assert_tie_contract(ref, new, t0, rtol=1e-6):
    live = t0 > 0
    t_r, t_n = _np(ref[0]), _np(new[0])
    np.testing.assert_allclose(np.where(live, t_r, 0.0),
                               np.where(live, t_n, 0.0), rtol=rtol)
    s_r, s_n = _np(ref[1]), _np(new[1])
    slot_match = s_r == s_n
    assert np.all(slot_match | (t_r == t_n) | ~live)
    same = slot_match & live & (s_r >= 0)
    assert same.sum() > 10                  # the field is actually hit
    np.testing.assert_allclose(_np(ref[2])[same], _np(new[2])[same],
                               atol=1e-4)
    np.testing.assert_array_equal(_np(ref[3])[same], _np(new[3])[same])


def _times(variant, mode, n):
    if variant != "motion" or mode == "none":
        return None
    return np.random.default_rng(5).uniform(0, 1, n).astype(np.float32)


RTOL = {"static": 1e-6, "imat": 1e-6, "motion": 1e-5}
CASES = [("static", "none"), ("imat", "none"), ("motion", "random"),
         ("motion", "none")]


def _port_set(field, variant):
    """The port's InstanceSet of ``field[variant]``, from its own
    ``expand_instances``, as CPU tensors."""
    cl, _ = field[variant]
    port = tcl.expand_instances(
        tcl.ClusterSet(**{f: getattr(cl, f) for f in tcl.ClusterSet._fields}),
        _placements(cl.aabb_min.shape[0], 5, variant))
    return tcl.InstanceSet(*(None if x is None else torch.as_tensor(x)
                             for x in port))


@pytest.mark.parametrize("variant", ["static", "imat", "motion"])
def test_placement_boxes_hold_their_expanded_boxes(field, variant):
    """Placement p's run [inst_first[p], inst_first[p+1]) is one instance
    (constant ``inst_id``, a new one each run), the runs cover every
    expanded cluster once in index order, and p's box is the union of the
    run's boxes, so each expanded box lies inside it."""
    inst = _port_set(field, variant)
    first = inst.inst_first.tolist()
    ce = inst.cmap.shape[0]
    assert first[0] == 0 and first[-1] == ce
    assert all(a < b for a, b in zip(first, first[1:]))
    assert inst.inst_first.dtype == torch.int32
    assert len(first) - 1 == 5 == int(torch.unique(inst.inst_id).numel())
    run = torch.repeat_interleave(torch.arange(len(first) - 1),
                                  torch.diff(inst.inst_first).long())
    assert torch.equal(run.to(torch.int32), inst.inst_id)
    assert bool((inst.aabb_min >= inst.inst_min[run]).all())
    assert bool((inst.aabb_max <= inst.inst_max[run]).all())
    for p in range(len(first) - 1):
        lo, hi = first[p], first[p + 1]
        assert torch.equal(inst.inst_min[p], inst.aabb_min[lo:hi].amin(0))
        assert torch.equal(inst.inst_max[p], inst.aabb_max[lo:hi].amax(0))


def _two_level_evals(cl, inst, o, d, t0, tm):
    """The instanced closest-hit kernel's sweep in plain torch: a ray
    enters a placement only where it pierces the placement's box against
    its best t, then sweeps the placement's expanded boxes in index order.
    Returns (pairs evaluated, best t)."""
    best = t0.clone()
    inv_d = tct._safe_inv(d)
    tt = tct._shutter_time(inst, tm, o.shape[0], o.device)
    first = inst.inst_first.tolist()
    n_eval = 0
    for p in range(len(first) - 1):
        inside = (best > 0.0) & tct._slab(o, inv_d, inst.inst_min[p],
                                          inst.inst_max[p], best)
        for e in range(first[p], first[p + 1]):
            hit = inside & tct._slab(o, inv_d, inst.aabb_min[e],
                                     inst.aabb_max[e], best)
            idx = torch.nonzero(hit).squeeze(1)
            n_eval += idx.numel()
            if idx.numel() == 0:
                continue
            o_e, d_e = tct._object_rays(inst, e, o[idx], d[idx],
                                        None if tt is None else tt[idx])
            bt = best[idx]
            t_pair = tct._pair_eval(o_e, d_e, cl.woop[int(inst.cmap[e])],
                                    bt[:, None])
            t_min = torch.min(t_pair, dim=1).values
            best[idx] = torch.where(t_min < bt, t_min, bt)
    return n_eval, best


@pytest.mark.parametrize("variant,tmode", CASES)
def test_placement_culling_evaluates_the_same_pairs(field, variant, tmode):
    """The two-level sweep evaluates exactly ``trace_inst_torch``'s pairs
    (its ``cluster_evals``) and finds its t bit for bit: the culling by
    placement boxes is exact."""
    cl = _to_torch(field[variant][0])
    inst = _port_set(field, variant)
    o, d = (torch.as_tensor(a) for a in _rays(301))
    t0 = torch.as_tensor(_t0(301))
    tm = _times(variant, tmode, 301)
    tm = None if tm is None else torch.as_tensor(tm)
    stats = {}
    ref = tct.trace_inst_torch(cl, inst, o, d, t0, time=tm, stats=stats)
    n_eval, best = _two_level_evals(cl, inst, o, d, t0, tm)
    assert n_eval == stats["cluster_evals"] > 0
    assert torch.equal(best, ref[0])


@pytest.mark.parametrize("variant,tmode", CASES)
def test_trace_inst_torch_matches_trace_jax_inst(field, variant, tmode):
    cl, inst = field[variant]
    o, d = _rays(301)                       # 301: not a tile multiple
    t0 = _t0(301)
    tm = _times(variant, tmode, 301)
    ref = jct.trace_jax_inst(
        _to_jax(cl), _to_jax(inst), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t0), time=None if tm is None else jnp.asarray(tm))
    stats = {}
    new = tct.trace_inst_torch(
        _to_torch(cl), _to_torch(inst), torch.as_tensor(o),
        torch.as_tensor(d), torch.as_tensor(t0),
        time=None if tm is None else torch.as_tensor(tm), stats=stats)
    _assert_tie_contract(ref, new, t0, RTOL[variant])
    miss = _np(new[1]) < 0
    np.testing.assert_array_equal(_np(new[0])[miss], t0[miss])
    assert not _np(new[2])[miss].any() and not _np(new[3])[miss].any()
    assert 0 < stats["cluster_evals"] <= stats["slab_tests"]
    if variant == "imat":
        assert np.isin(_np(new[3]), (11, 13)).sum() > 0     # overrides seen
    if variant == "motion" and tmode == "none":
        # No time given means mid-shutter for every ray.
        half = tct.trace_inst_torch(
            _to_torch(cl), _to_torch(inst), torch.as_tensor(o),
            torch.as_tensor(d), torch.as_tensor(t0),
            time=torch.full((301,), 0.5))
        for a, b in zip(new, half):
            assert torch.equal(a, b)


@pytest.mark.parametrize("variant,tmode", [("imat", "none"),
                                           ("motion", "random")])
def test_trace_inst_matches_pallas_kernel_interpret(field, variant, tmode):
    cl, inst = field[variant]
    o, d = _rays(256, seed=7)
    t0 = _t0(256)
    tm = _times(variant, tmode, 256)
    ref = jct.trace_pallas_dnf_inst(
        _to_jax(cl), _to_jax(inst), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t0), time=None if tm is None else jnp.asarray(tm),
        interpret=True)
    new = tct.trace_inst(
        _to_torch(cl), _to_torch(inst), torch.as_tensor(o),
        torch.as_tensor(d), torch.as_tensor(t0),
        time=None if tm is None else torch.as_tensor(tm))
    _assert_tie_contract(ref, new, t0, RTOL[variant])


@pytest.mark.parametrize("variant,tmode", [("static", "none"),
                                           ("motion", "random")])
def test_occluded_inst_matches_pallas_kernel_interpret(field, variant,
                                                       tmode):
    cl, inst = field[variant]
    o, d = _rays(256, seed=3)
    cap = _t0(256, 20.0)
    tm = _times(variant, tmode, 256)
    ref = jct.occluded_pallas_dnf_inst(
        _to_jax(cl), _to_jax(inst), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(cap), time=None if tm is None else jnp.asarray(tm),
        interpret=True)
    args = (_to_torch(cl), _to_torch(inst), torch.as_tensor(o),
            torch.as_tensor(d), torch.as_tensor(cap))
    kw = dict(time=None if tm is None else torch.as_tensor(tm))
    new = tct.occluded_inst(*args, **kw)
    t_hit = tct.trace_inst_torch(*args, **kw)[0].numpy()
    # A hit within float noise of the cap may fall on either side of it.
    near_cap = np.abs(t_hit - cap) <= 1e-5 * cap
    agree = (_np(ref) == _np(new)) | near_cap
    assert agree.all()
    assert 10 < int(_np(new).sum()) < 256 - 24


@pytest.mark.parametrize("variant", ["static", "imat", "motion"])
def test_occluded_inst_equals_capped_trace(field, variant):
    """Inside the port the any-hit sweep is the closest-hit sweep capped at
    t_max, bit for bit; the override column changes nothing."""
    cl, inst = field[variant]
    o, d = _rays(200, seed=9)
    cap = (np.random.default_rng(9).uniform(5, 25, 200)).astype(np.float32)
    cap[::11] = 0.0
    args = (_to_torch(cl), _to_torch(inst), torch.as_tensor(o),
            torch.as_tensor(d), torch.as_tensor(cap))
    tm = _times(variant, "random", 200)
    kw = dict(time=None if tm is None else torch.as_tensor(tm))
    occ = tct.occluded_inst_torch(*args, **kw)
    slot = tct.trace_inst_torch(*args, **kw)[1]
    assert torch.equal(occ, slot >= 0)
    assert torch.equal(occ, tct.occluded_inst(*args, **kw))
    assert 0 < int(occ.sum()) < 200


def test_empty_instance_set_passes_through(field):
    cl, inst = field["static"]
    empty = tcl.InstanceSet(*(None if x is None else x[:0] for x in inst))
    o, d = _rays(16)
    t0 = torch.as_tensor(_t0(16))
    before = dict(tct.LAUNCHES)
    t, slot, n, m = tct.trace_inst(_to_torch(cl), _to_torch(empty),
                                   torch.as_tensor(o), torch.as_tensor(d),
                                   t0)
    assert torch.equal(t, t0) and bool((slot == -1).all())
    assert not n.any() and not m.any()
    occ = tct.occluded_inst(_to_torch(cl), _to_torch(empty),
                            torch.as_tensor(o), torch.as_tensor(d), t0)
    assert occ.dtype == torch.bool and not occ.any()
    assert tct.LAUNCHES == before


def test_instanced_wrappers_refuse_other_devices(field):
    """A tensor on neither the CPU nor a CUDA device (here ``meta``) must
    raise: the wrappers take the plain path only for CPU tensors."""
    cl, inst = field["motion"]
    cl_m = tcl.ClusterSet(*(x.to("meta") for x in _to_torch(cl)))
    inst_m = tcl.InstanceSet(*(None if x is None else x.to("meta")
                               for x in _to_torch(inst)))
    o = torch.zeros((4, 3), device="meta")
    t = torch.ones(4, device="meta")
    before = dict(tct.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tct.trace_inst(cl_m, inst_m, o, o, t)
    with pytest.raises(ValueError, match="CUDA"):
        tct.occluded_inst(cl_m, inst_m, o, o, t, time=t)
    assert tct.LAUNCHES == before


# --- SceneBuilder and the scene routes ------------------------------------


def _instanced_cornell(mod, scenes_mod, kind="plain", n=4, device=None):
    """Cornell box with ``n`` instanced icospheres (tests/test_instances.py).
    ``kind``: "plain", "identity" (one identity instance), "override" (one
    material override) or "motion" (every instance moves)."""
    b = mod.SceneBuilder()
    scenes_mod._cornell_walls(b)
    metal = b.metal((0.8, 0.8, 0.9), 0.1)
    red = b.lambertian((0.7, 0.1, 0.1))
    verts, faces = scenes_mod.icosphere(1, 0.2)
    ts, mts = [], []
    for i in range(1 if kind == "identity" else n):
        a = _rot_y(0.7 * i) @ np.diag([1.0, 0.8, 1.1])
        t = np.array([-0.6 + 0.4 * i, -0.75, -0.3])
        ts.append(EYE if kind == "identity"
                  else np.concatenate([a, t[:, None]], axis=1))
        mts.append(np.concatenate(
            [_rot_y(0.7 * i + 0.4) @ np.diag([1.0, 0.8, 1.1]),
             (t + [0.0, 0.25, 0.1])[:, None]], axis=1))
    b.add_instances(
        verts, faces, metal, ts,
        materials=[None, red] + [None] * (n - 2) if kind == "override"
        else None,
        motion_transforms=mts if kind == "motion" else None)
    scene = b.build() if device is None else b.build(device)
    return scene, (verts, faces, metal, red)


@pytest.fixture(scope="module")
def cornells():
    return {k: (_instanced_cornell(jscene_mod, jscenes, k)[0],
                _instanced_cornell(tscene_mod, tscenes, k, device="cpu")[0])
            for k in ("plain", "override", "motion")}


@pytest.mark.parametrize("kind", ["plain", "override", "motion"])
def test_scene_instanced_tables_byte_equal(cornells, kind):
    j, t = cornells[kind]
    _assert_tables_equal(j.instances, t.instances)
    for f in tcl.ClusterSet._fields:
        assert _np(getattr(j.clusters, f)).tobytes() == _np(
            getattr(t.clusters, f)).tobytes(), f
    assert tscene_mod.uses_dnf(t)
    assert tscene_mod.has_motion(t) == (kind == "motion")
    assert jscene_mod.has_motion(j) == (kind == "motion")


def test_scene_from_numpy_carries_instances(cornells):
    j, t = cornells["motion"]
    s = tscene_mod.scene_from_numpy(jax.tree.map(np.asarray, j), "cpu")
    _assert_tables_equal(s.instances, t.instances)
    assert tscene_mod.has_motion(s)


def _cornell_rays(n=256, seed=5):
    o, d = _rays(n, seed=seed)
    o = o * 0.1 + np.array([0.0, 0.0, 3.0], np.float32)
    tgt = np.random.default_rng(seed).uniform(-0.9, 0.9, (n, 3)) * [
        1.0, 0.3, 0.5] + [0.0, -0.7, -0.2]
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("kind", ["override", "motion"])
def test_intersect_and_occluded_batch_match_jax(cornells, kind):
    j, t = cornells[kind]
    o, d = _cornell_rays()
    n = o.shape[0]
    active = np.ones(n, bool)
    active[::7] = False
    tm = (np.random.default_rng(2).uniform(0, 1, n).astype(np.float32)
          if kind == "motion" else None)
    hj = jscene_mod.intersect_batch(
        j, jnp.asarray(o), jnp.asarray(d), "cluster_jax",
        active=jnp.asarray(active),
        time=None if tm is None else jnp.asarray(tm))
    ht = tscene_mod.intersect_batch(
        t, torch.as_tensor(o), torch.as_tensor(d), "cluster_torch",
        active=torch.as_tensor(active),
        time=None if tm is None else torch.as_tensor(tm))
    m = active
    np.testing.assert_array_equal(np.asarray(hj.valid)[m],
                                  ht.valid.numpy()[m])
    v = m & ht.valid.numpy()
    np.testing.assert_allclose(np.asarray(hj.t)[v], ht.t.numpy()[v],
                               rtol=RTOL["motion"])
    np.testing.assert_allclose(np.asarray(hj.normal)[v],
                               ht.normal.numpy()[v], atol=1e-4)
    np.testing.assert_array_equal(np.asarray(hj.mat_id)[m],
                                  ht.mat_id.numpy()[m])
    assert (ht.slot.numpy()[v] >= 128).sum() > 10      # instances are hit
    t_max = np.full(n, 3.0, np.float32)
    oj = jscene_mod.occluded_batch(
        j, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
        "cluster_jax", active=jnp.asarray(active),
        time=None if tm is None else jnp.asarray(tm))
    ot = tscene_mod.occluded_batch(
        t, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max),
        "cluster_torch", active=torch.as_tensor(active),
        time=None if tm is None else torch.as_tensor(tm))
    np.testing.assert_array_equal(np.asarray(oj), ot.numpy())


def test_override_flows_to_hits(cornells):
    _, t = cornells["override"]
    o, d = _cornell_rays(512)
    hit = tscene_mod.intersect_batch(t, torch.as_tensor(o),
                                     torch.as_tensor(d), "cluster_torch")
    mats = set(hit.mat_id[hit.valid & (hit.slot >= 128)].tolist())
    metal, red = 4, 5            # ids after the four Cornell materials
    assert mats == {metal, red}


def test_identity_instance_matches_flat_mesh_bitwise():
    """One identity-transform instance ≡ the same mesh added flat: the
    instanced route's identity transform is an exact pass-through."""
    scene_i, (verts, faces, metal, _) = _instanced_cornell(
        tscene_mod, tscenes, "identity", device="cpu")
    b = tscene_mod.SceneBuilder()
    tscenes._cornell_walls(b)
    assert b.metal((0.8, 0.8, 0.9), 0.1) == metal
    b.lambertian((0.7, 0.1, 0.1))
    b.add_mesh(verts, faces, metal)
    scene_f = b.build("cpu")
    assert scene_i.instances is not None and scene_f.instances is None

    o, d = _rays(256, seed=5)
    o = o * 0.1 + np.array([0.0, 0.0, 3.0], np.float32)
    d = -o / np.linalg.norm(o, axis=1, keepdims=True)
    o, d = torch.as_tensor(o), torch.as_tensor(d.astype(np.float32))
    for trav in ("cluster_torch", "cluster_cuda"):
        hi = tscene_mod.intersect_batch(scene_i, o, d, trav)
        hf = tscene_mod.intersect_batch(scene_f, o, d, trav)
        assert torch.equal(hi.valid, hf.valid)
        assert torch.equal(hi.t[hi.valid], hf.t[hf.valid])
        assert torch.equal(hi.mat_id, hf.mat_id)
        cap = torch.full((256,), 5.0)
        assert torch.equal(
            tscene_mod.occluded_batch(scene_i, o, d, cap, trav),
            tscene_mod.occluded_batch(scene_f, o, d, cap, trav))
    assert int((hi.slot >= 128).sum()) > 10


def _guard_cases():
    verts, faces = tscenes.icosphere(0, 0.2)

    def fresh():
        b = tscene_mod.SceneBuilder()
        return b, b.lambertian((0.7, 0.7, 0.7)), b.emissive((5.0, 5.0, 5.0))

    def emissive_prototype():
        b, _, light = fresh()
        b.add_instances(verts, faces, light, [EYE])
        b.build("cpu")

    def emissive_override():
        b, white, light = fresh()
        b.add_instances(verts, faces, white, [EYE], materials=[light])
        b.build("cpu")

    def singular():
        fresh()[0].add_instances(verts, faces, 0, [np.zeros((3, 4))])

    def bad_shape():
        fresh()[0].add_instances(verts, faces, 0, [np.eye(2)])

    def no_transforms():
        fresh()[0].add_instances(verts, faces, 0, [])

    def materials_mismatch():
        fresh()[0].add_instances(verts, faces, 0, [EYE, EYE],
                                   materials=[0])

    def motion_mismatch():
        fresh()[0].add_instances(verts, faces, 0, [EYE, EYE],
                                   motion_transforms=[EYE])

    def motion_singular():
        fresh()[0].add_instances(verts, faces, 0, [EYE],
                                   motion_transforms=[np.zeros((3, 4))])

    def motion_bad_shape():
        fresh()[0].add_instances(verts, faces, 0, [EYE],
                                   motion_transforms=[np.eye(2)])

    def over_budget():
        # Static placements past the budget take the two-level walk
        # (tests/test_torch_inst_tree.py); moving ones still raise.
        b, white, _ = fresh()
        b.add_instances(verts, faces, white,
                        [EYE] * (tct.DNF_MAX_CLUSTERS + 1),
                        motion_transforms=[EYE] * (tct.DNF_MAX_CLUSTERS + 1))
        b.build("cpu")

    return {
        "emissive_prototype": (emissive_prototype, "emissive materials"),
        "emissive_override": (emissive_override, "overrides cannot be"),
        "singular": (singular, "instance transform is singular"),
        "bad_shape": (bad_shape, r"instance transform must be \(3,4\)"),
        "no_transforms": (no_transforms, "at least one transform"),
        "materials_mismatch": (materials_mismatch, "materials must match"),
        "motion_mismatch": (motion_mismatch,
                            "motion_transforms must match"),
        "motion_singular": (motion_singular,
                            "motion transform is singular"),
        "motion_bad_shape": (motion_bad_shape,
                             r"motion transform must be \(3,4\)"),
        "over_budget": (over_budget, "exceed the DNF budget"),
    }


@pytest.mark.parametrize("case", sorted(_guard_cases()))
def test_add_instances_guards_raise(case):
    fn, match = _guard_cases()[case]
    with pytest.raises(ValueError, match=match):
        fn()


def test_guards_raise_as_in_jax():
    """The same calls raise ValueError in the JAX package."""
    verts, faces = jscenes.icosphere(0, 0.2)
    b = jscene_mod.SceneBuilder()
    light = b.emissive((5.0, 5.0, 5.0))
    b.add_instances(verts, faces, light, [EYE])
    with pytest.raises(ValueError, match="emissive materials"):
        b.build()
    with pytest.raises(ValueError, match="motion_transforms must match"):
        jscene_mod.SceneBuilder().add_instances(
            verts, faces, 0, [EYE, EYE], motion_transforms=[EYE])


def test_bvh_traversal_refused_for_instanced_scenes(cornells):
    _, t = cornells["plain"]
    o, d = (torch.as_tensor(x) for x in _rays(8))
    with pytest.raises(ValueError, match="BVH"):
        tscene_mod.intersect_batch(t, o, d, "bvh")
    with pytest.raises(ValueError, match="BVH"):
        tscene_mod.occluded_batch(t, o, d, torch.ones(8), "bvh")
    with pytest.raises(ValueError, match="unknown traversal"):
        tscene_mod.intersect_batch(t, o, d, "cluster_pallas")


# --- the engine ----------------------------------------------------------


@pytest.mark.parametrize("sampler", ["ld", "independent"])
def test_shutter_time_draws_equal(sampler):
    pix = np.arange(600, dtype=np.int32)
    seed, sample = 9, 4
    if sampler == "ld":
        ref = jax.vmap(lambda p: jrng.ld_scalar(
            jnp.uint32(seed), p, jnp.int32(sample), jrng.STREAM_TIME))(
                jnp.asarray(pix))
    else:
        ref = jax.vmap(lambda p: jax.random.uniform(
            jrng.stream_key(jrng.pixel_sample_key(jnp.uint32(seed), p,
                                                  jnp.int32(sample)),
                            0, jrng.STREAM_TIME), (), dtype=jnp.float32))(
                jnp.asarray(pix))
    tpix = torch.as_tensor(pix).long()
    new = tmega.shutter_times(TConfig(sampler=sampler), seed, tpix, sample,
                              trng.pixel_sample_key(seed, tpix, sample))
    np.testing.assert_array_equal(np.asarray(ref), new.numpy())
    assert 0.0 <= float(new.min()) and float(new.max()) < 1.0


def _render_pair(scene_j, scene_t, cam_cfg, **kw):
    img_j = np.asarray(jprog.render_once(
        scene_j, jcamera(cam_cfg, 1.0), JConfig(traversal="cluster_jax",
                                                **kw)))
    img_t = tprog.render_once(scene_t, tcamera(cam_cfg, 1.0, device="cpu"),
                              TConfig(**kw)).numpy()
    assert img_t.shape == img_j.shape and np.isfinite(img_t).all()
    diff = np.abs(img_j - img_t).max(axis=-1)
    assert (diff > 1e-3).mean() <= 0.01
    assert abs(img_t.mean() - img_j.mean()) <= 0.01 * img_j.mean()
    return img_t


def test_instanced_demo_render_matches_jax():
    scene_j, cam_cfg = jscenes.instanced_demo(grid=3, subdivisions=1)
    scene_t, _ = tscenes.instanced_demo(grid=3, subdivisions=1, device="cpu")
    _assert_tables_equal(scene_j.instances, scene_t.instances)
    assert tscenes.preferred_background("instanced_demo") == "gradient"
    assert (tscenes.preferred_background("many_lights_demo")
            == jscenes.preferred_background("many_lights_demo") == "black")
    img = _render_pair(scene_j, scene_t, cam_cfg, width=32, height=32,
                       samples_per_pixel=2, max_depth=4, seed=1, nee=True,
                       background="gradient")
    assert img.mean() > 0.05


def test_motion_blur_render_matches_jax(cornells):
    """Depth 5 crosses the live-first compaction (depth 3), which must
    carry the per-path shutter times along."""
    j, t = cornells["motion"]
    img = _render_pair(j, t, jscenes.CORNELL_CAMERA, width=24, height=24,
                       samples_per_pixel=2, max_depth=5, seed=2, nee=True)
    assert img.mean() > 0.05


# The placement boxes staged in shared memory at a time by both instanced
# kernels (csrc/cluster_common.cuh kBoxChunk).
BOX_CHUNK = 1024


def _two_level_any(cl, inst, o, d, cap, tm):
    """The instanced any-hit kernel's sweep in plain torch: placements in
    chunks of ``BOX_CHUNK``, a pending ray (live, not yet occluded) enters
    a placement only where it pierces the placement's box against its cap,
    then sweeps the placement's expanded boxes in index order and retires
    at its first occluding pair. Returns (pairs evaluated, occlusion)."""
    occ = torch.zeros(o.shape[0], dtype=torch.bool)
    inv_d = tct._safe_inv(d)
    tt = tct._shutter_time(inst, tm, o.shape[0], o.device)
    first = inst.inst_first.tolist()
    n_inst = len(first) - 1
    n_eval = 0
    for p0 in range(0, n_inst, BOX_CHUNK):
        for p in range(p0, min(p0 + BOX_CHUNK, n_inst)):
            inside = (cap > 0.0) & ~occ & tct._slab(
                o, inv_d, inst.inst_min[p], inst.inst_max[p], cap)
            for e in range(first[p], first[p + 1]):
                hit = inside & ~occ & tct._slab(o, inv_d, inst.aabb_min[e],
                                                inst.aabb_max[e], cap)
                idx = torch.nonzero(hit).squeeze(1)
                n_eval += idx.numel()
                if idx.numel() == 0:
                    continue
                o_e, d_e = tct._object_rays(inst, e, o[idx], d[idx],
                                            None if tt is None else tt[idx])
                t_pair = tct._pair_eval(o_e, d_e,
                                        cl.woop[int(inst.cmap[e])],
                                        cap[idx][:, None])
                occ[idx] = torch.min(t_pair, dim=1).values < cap[idx]
    return n_eval, occ


@pytest.mark.parametrize("variant,tmode", CASES)
def test_placement_culling_any_hit_evaluates_the_same_pairs(field, variant,
                                                            tmode):
    """The two-level any-hit sweep, lanes retired at their first occluder,
    evaluates exactly ``occluded_inst_torch``'s pairs (its
    ``cluster_evals``) and gives its occlusion: the culling by placement
    boxes is exact for the any hit too."""
    cl = _to_torch(field[variant][0])
    inst = _port_set(field, variant)
    o, d = (torch.as_tensor(a) for a in _rays(301, seed=13))
    cap = (np.random.default_rng(13).uniform(5, 25, 301)).astype(np.float32)
    cap[::11] = 0.0
    cap = torch.as_tensor(cap)
    tm = _times(variant, tmode, 301)
    tm = None if tm is None else torch.as_tensor(tm)
    stats = {}
    ref = tct.occluded_inst_torch(cl, inst, o, d, cap, time=tm, stats=stats)
    n_eval, occ = _two_level_any(cl, inst, o, d, cap, tm)
    assert n_eval == stats["cluster_evals"] > 0
    assert torch.equal(occ, ref)
    assert 0 < int(occ.sum()) < int((cap > 0).sum())


def test_placement_boxes_past_one_chunk():
    """A field of more than ``BOX_CHUNK`` placements (1,089 one-cluster
    instances and the base geometry) keeps each placement's run and box
    right across the chunk edge, and the two-level any hit over two chunks
    gives ``occluded_inst_torch``'s occlusion from the same pairs."""
    scene, _ = tscenes.instanced_demo(grid=33, subdivisions=0, device="cpu")
    inst = scene.instances
    first = inst.inst_first.tolist()
    n_inst = len(first) - 1
    assert n_inst == 1090 > BOX_CHUNK
    assert first[0] == 0 and first[-1] == inst.cmap.shape[0]
    assert all(a < b for a, b in zip(first, first[1:]))
    run = torch.repeat_interleave(torch.arange(n_inst),
                                  torch.diff(inst.inst_first).long())
    assert torch.equal(run.to(torch.int32), inst.inst_id)
    for p in range(BOX_CHUNK - 3, BOX_CHUNK + 3):
        lo, hi = first[p], first[p + 1]
        assert torch.equal(inst.inst_min[p], inst.aabb_min[lo:hi].amin(0))
        assert torch.equal(inst.inst_max[p], inst.aabb_max[lo:hi].amax(0))
    assert bool((inst.aabb_min >= inst.inst_min[run]).all())
    assert bool((inst.aabb_max <= inst.inst_max[run]).all())
    # Rays from above the field down onto it, aimed at placements on
    # both sides of the chunk edge.
    rs = np.random.default_rng(14)
    n = 97
    c = inst.inst_min[BOX_CHUNK - 40:BOX_CHUNK + 40]
    tgt = c[rs.integers(0, c.shape[0], n)].numpy() + rs.uniform(
        -0.5, 1.5, (n, 3))
    o = tgt + rs.uniform(-2.0, 2.0, (n, 3)) * [1.0, 0.0, 1.0] + [0, 6.0, 0]
    d = tgt - o
    dist = np.linalg.norm(d, axis=1)
    cap = (dist * rs.uniform(0.5, 1.5, n)).astype(np.float32)
    cap[::11] = 0.0
    o, d, cap = (torch.as_tensor(a.astype(np.float32)) for a in
                 (o, d / dist[:, None], cap))
    stats = {}
    ref = tct.occluded_inst_torch(scene.clusters, inst, o, d, cap,
                                  stats=stats)
    n_eval, occ = _two_level_any(scene.clusters, inst, o, d, cap, None)
    assert n_eval == stats["cluster_evals"] > 0
    assert torch.equal(occ, ref)
    assert 5 < int(occ.sum()) < int((cap > 0).sum()) - 5
