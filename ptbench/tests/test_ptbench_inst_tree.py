"""The instanced field's cell (``instanced_field64.progressive``) on the
CPU: its reference (``scenes/instanced_field_woop.py``, ``reference/
woop.py``) computes the port's camera frame and triangle arithmetic, and
traces what the port's two-level walk traces bit for bit; a tiny field
through the two-level route (the budget lowered) is correct, a nudged
placement makes it incorrect, the bfloat16 control fails, and
``placements_per_ray`` reads the walk's counts."""

import copy
import json

import numpy as np
import pytest
import torch

from ptbench import calibrate, spec
from ptbench.reference import woop
from ptbench.scenes import cornell_mesh, instanced_field_woop
from ptbench.tests import _tiny

FIELD = {"grid": 3, "subdivisions": 2, "radius": 0.45, "spacing": 1.5,
         "placement_seed": 7}
CELL = "field3.progressive"


def _config():
    with open(spec.HERE + "/configs/instanced_field64.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def field_bench(tmp_path_factory):
    """``BENCHMARK.json`` with the field's configuration shrunk to 3 x 3
    placements, its cell, and ``placements_per_ray`` reported there."""
    path = tmp_path_factory.mktemp("field") / "field3.json"
    config = dict(_config(), **FIELD, name="field3")
    path.write_text(json.dumps(config))
    bench = copy.deepcopy(spec.load())
    bench["configs"].append({"name": "field3", "source": "a test",
                             "file": str(path), "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": CELL, "config": "field3",
                               "traffic": "progressive", "chips": 1,
                               "why": "a test"})
    for m in bench["per_layer"]:
        if m["name"] == "placements_per_ray":
            m["workloads"].append(CELL)
    return bench


@pytest.fixture
def two_level(monkeypatch):
    """The port's budget lowered under the tiny field's 27 placed
    clusters, so it takes the two-level route; the routes' queries are
    recorded."""
    from pathtracing_tpu_torch.models import scene as scene_mod
    from pathtracing_tpu_torch.ops import cluster_trace as ct

    monkeypatch.setattr(ct, "DNF_MAX_CLUSTERS", 4)
    taken = []
    for key in [k for k in scene_mod._ROUTES if k[1] == "inst_tree"]:
        plain, kernel = scene_mod._ROUTES[key]

        def recorded(*args, _plain=plain, _key=key, **kwargs):
            taken.append(_key)
            return _plain(*args, **kwargs)

        monkeypatch.setitem(scene_mod._ROUTES, key, (recorded, kernel))
    return taken


def test_the_cells_configuration_takes_this_reference():
    config = _config()
    assert config["scene"] == "instanced_field_woop"
    assert {k: config[k] for k in ("grid", "subdivisions", "radius",
                                   "spacing", "placement_seed")} == {
        "grid": 64, "subdivisions": 6, "radius": 0.45, "spacing": 1.5,
        "placement_seed": 7}


@pytest.mark.parametrize("scene", ["field", "cornell"])
def test_the_frame_is_the_ports(scene):
    from pathtracing_tpu_torch.ops.camera import build_camera
    from pathtracing_tpu_torch.utils.config import CameraConfig

    cam = (instanced_field_woop.scene_data(_config()) if scene == "field"
           else cornell_mesh.scene_data({"subdivisions": 1}))["camera"]
    want = build_camera(CameraConfig(**cam), 16 / 9, device="cpu")
    got = instanced_field_woop.frame(cam, 16 / 9)
    for x, name in zip(got, ("origin", "lower_left", "horizontal",
                             "vertical")):
        assert x.dtype == np.float32
        assert x.tobytes() == getattr(want, name).numpy().tobytes(), name


def test_woop_rows_and_normals_are_the_ports_table():
    from pathtracing_tpu_torch.ops import clusters

    data = instanced_field_woop.scene_data(dict(_config(), subdivisions=3))
    v0, e1, e2, mat = instanced_field_woop.proto_triangles(data)
    cs, _, slot_to_tri = clusters.build_clusters(v0, e1, e2, mat)
    rows, normal = woop.woop_rows(v0, e1, e2)
    k = clusters.CLUSTER_SIZE
    c = cs.woop.shape[0]
    w = cs.woop.reshape(c, 4, 3, k)
    port = np.concatenate(
        [np.transpose(w[:, :3], (0, 3, 2, 1)).reshape(c, k, 9),
         np.transpose(w[:, 3], (0, 2, 1))], axis=2)
    tri = slot_to_tri.reshape(c, k)
    live = tri >= 0
    assert live.sum() == len(v0)
    assert np.array_equal(rows[tri[live]].view(np.int32),
                          port[live].view(np.int32))
    assert np.array_equal(normal[tri[live]].view(np.int32),
                          np.transpose(cs.normal, (0, 2, 1))[live]
                          .view(np.int32))


def test_the_reference_hits_what_the_two_level_walk_hits(two_level):
    """Camera rays of a 6 x 6 field, then rays from their hits: the
    reference's t equals the port's plain two-level walk's bit for bit,
    and so does the any hit."""
    from pathtracing_tpu_torch.models import scene as scene_mod

    config = dict(_config(), grid=6, subdivisions=3)
    data = instanced_field_woop.scene_data(config)
    port = instanced_field_woop.build_port(data, "cpu")
    assert port.inst_tree is not None
    ref = instanced_field_woop.reference(data, config, "cpu")
    g = torch.Generator().manual_seed(11)
    n = 3000
    pos = torch.tensor(data["camera"]["position"], dtype=torch.float32)
    target = (torch.rand(n, 3, generator=g) - 0.5) * torch.tensor(
        [12.0, 1.0, 12.0])
    d = target - pos
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    o = pos.expand(n, 3).contiguous()
    for _ in range(2):
        hit = scene_mod.intersect_batch(port, o, d, "cluster_torch")
        t_port = torch.where(hit.valid, hit.t, torch.inf)
        t_ref, _ = ref.geo.closest(o, d, torch.full((n,), 3.0e38))
        assert torch.equal(t_port.view(torch.int32), t_ref.view(torch.int32))
        cap = torch.where(hit.valid, hit.t * 0.999, 2.0)
        occ = scene_mod.occluded_batch(port, o, d, cap, "cluster_torch")
        t_occ, _ = ref.geo.closest(o, d, cap)
        assert torch.equal(occ, t_occ < cap)
        assert 0 < int(hit.valid.sum()) < n
        # From the hits, in random directions.
        o = torch.where(hit.valid[:, None],
                        o + torch.where(hit.valid, hit.t, 0.0)[:, None] * d,
                        o)
        d = torch.randn(n, 3, generator=g)
        d = d / torch.linalg.norm(d, dim=1, keepdim=True)


def test_a_tiny_field_is_correct_through_the_two_level_route(field_bench,
                                                             two_level):
    res = _tiny.run_tiny(CELL, bench=field_bench)
    assert {("trace", "inst_tree"), ("occluded", "inst_tree")} <= set(
        two_level)
    assert res["correct"], res["compared"]
    assert res["compared"]["median_gap"]["value"] <= 1e-5


def test_a_nudged_placement_in_the_two_level_walk_makes_the_run_incorrect(
        field_bench, two_level, monkeypatch):
    """The two-level closest hit traces every placement but the base
    geometry (placement 0) moved by 0.05 in x."""
    from pathtracing_tpu_torch.models import scene as scene_mod

    plain, kernel = scene_mod._ROUTES[("trace", "inst_tree")]

    def nudged(clusters, itree, origin, direction, *args, **kwargs):
        xform = itree.xform.clone()
        xform[1:, 9] += 0.05
        return plain(clusters, itree._replace(xform=xform), origin,
                     direction, *args, **kwargs)

    monkeypatch.setitem(scene_mod._ROUTES, ("trace", "inst_tree"),
                        (nudged, kernel))
    res = _tiny.run_tiny(CELL, bench=field_bench)
    assert not res["correct"], res["compared"]


def test_placements_per_ray_reads_the_two_level_walks_counts(field_bench,
                                                              two_level):
    res = _tiny.run_tiny(CELL, bench=field_bench, trace=True)
    assert res["metrics"]["placements_per_ray"]["value"] > 0.0
    reader = spec.metric_module("placements_per_ray")
    # A program, or a route, that counts no placements: nothing.
    assert reader.read({"counts": {"segments": 8, "shadow_segments": 3,
                                   "samples": 4}}) is None
    assert reader.read({"counts": None}) is None


@pytest.mark.parametrize("seed", [2**31 + 5, 3])
def test_the_bfloat16_control_fails_a_limit_on_the_field(field_bench, seed):
    nums = calibrate.control_numbers(field_bench, CELL, seed, 4, "cpu",
                                     overrides=_tiny.overrides(), pixels=64)
    limits = _tiny.limits()
    assert (nums["median_gap"] > limits["median_gap"]
            or nums["off_share"] > limits["off_share"]), nums
