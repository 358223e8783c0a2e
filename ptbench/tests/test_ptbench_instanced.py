"""The instanced reference (``reference/instanced.py``) and the hook that
lets a scene module bring its own reference (``check.reference_of``), on
the CPU: identity placements trace the flat reference's bits, affine
placements hit what the flattened world triangles hit, and a tiny
instanced field runs through ``run.py`` on the port's CPU route, correct,
with a planted fault and the bfloat16 control failing."""

import json

import numpy as np
import pytest
import torch

from ptbench import calibrate, check, spec
from ptbench.reference import instanced, pathtrace
from ptbench.scenes import cornell_mesh, instanced_field
from ptbench.tests import _tiny

FIELD = {"grid": 3, "subdivisions": 2, "radius": 0.45, "spacing": 1.5,
         "placement_seed": 7}
CELL = "field3.progressive"


def _eye():
    return np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)


def test_identity_placements_give_the_flat_sums_bit_for_bit():
    """The Cornell box with its icosphere as one identity placement,
    against the flat reference over the same triangles in the same row
    order (the quads, then the sphere)."""
    data = cornell_mesh.scene_data({"subdivisions": 2})
    tris = cornell_mesh.triangles(data)
    n_mesh = len(data["mesh"][1])
    proto = tuple(x[:n_mesh] for x in tris)
    base = tuple(x[n_mesh:] for x in tris)
    flat = tuple(np.concatenate([b, p]) for b, p in zip(base, proto))
    config = {"width": 32, "height": 32, "max_depth": 8}
    ref_flat = check.Reference(data, flat, config, "cpu")
    geo = instanced.prepare(base, [proto], [(0, _eye(), -1)], "cpu")
    ref_inst = check.Reference(data, base, config, "cpu", geo=geo)
    pix = np.arange(32 * 32)
    spp = np.full(pix.size, 2)
    for light_flat, light_inst in zip(ref_flat.orders, ref_inst.orders):
        assert torch.equal(ref_flat.sums(2**33 + 5, pix, spp, light_flat),
                           ref_inst.sums(2**33 + 5, pix, spp, light_inst))


def _flattened(data):
    """The field's world triangles, base rows then each placement's, as
    the instanced reference numbers its rows, with overrides applied."""
    base = instanced_field.base_triangles(data)
    v0, e1, e2, mat = instanced_field.proto_triangles(data)
    corners = [np.asarray(c, np.float64) for c in (v0, v0 + e1, v0 + e2)]
    parts = [base]
    for m, override in data["placements"]:
        w = [(c @ m[:, :3].T + m[:, 3]).astype(np.float32) for c in corners]
        parts.append((w[0], w[1] - w[0], w[2] - w[0],
                      mat if override < 0 else np.full_like(mat, override)))
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(4))


@pytest.mark.parametrize("runs_of", [instanced.SUPER, 2])
def test_affine_placements_hit_what_the_flattened_triangles_hit(
        runs_of, monkeypatch):
    """A 3x3 field of a 320-triangle icosphere (turned, squashed
    anisotropically, moved), rays from around it: the same hits as the
    flat reference over the world triangles, t within 1e-5 relative, the
    same (placement, triangle) but at tied t, the overrides' materials.
    With runs of 2 boxes, placements and prototype groups sit under
    several boxes more each."""
    monkeypatch.setattr(instanced, "SUPER", runs_of)
    data = instanced_field.scene_data(FIELD)
    flat = pathtrace.prepare(*_flattened(data), "cpu")
    geo = instanced.prepare(instanced_field.base_triangles(data),
                            [instanced_field.proto_triangles(data)],
                            [(0, m, o) for m, o in data["placements"]], "cpu")
    gen = torch.Generator().manual_seed(3)
    n = 20000
    o = pathtrace._normalize(torch.randn(n, 3, generator=gen)) * 8.0
    o[:, 1] = o[:, 1].abs() + 0.5
    target = (torch.rand(n, 3, generator=gen) * torch.tensor([4.0, 1.6, 4.0])
              - torch.tensor([2.0, 0.0, 2.0]))
    d = pathtrace._normalize(target - o)
    t_max = torch.full((n,), 1e30)
    t_flat, row_flat = flat.closest(o, d, t_max)
    t_inst, row_inst = geo.closest(o, d, t_max)
    hit = row_flat >= 0
    assert torch.equal(hit, row_inst >= 0)
    assert int(hit.sum()) > n // 2
    assert torch.allclose(t_inst[hit], t_flat[hit], rtol=1e-5, atol=0.0)
    tied = (t_flat - t_inst).abs() <= 1e-5 * t_flat
    assert bool(((row_flat == row_inst) | tied)[hit].all())
    same = hit & (row_flat == row_inst)
    n_flat, m_flat = flat.surface(row_flat[same])
    n_inst, m_inst = geo.surface(row_inst[same])
    assert torch.equal(m_flat, m_inst)
    assert {int(m) for m in m_inst} >= {instanced_field.BODY,
                                        instanced_field.RUST,
                                        instanced_field.SKY}
    assert torch.allclose(n_inst, n_flat, atol=1e-5)


def test_the_hook_takes_the_scene_modules_reference_where_it_has_one():
    config = dict(FIELD, width=16, height=16, max_depth=8)
    data = instanced_field.scene_data(config)
    ref = check.reference_of(instanced_field, data, config, "cpu")
    assert isinstance(ref.geo, instanced.Instanced)
    data = cornell_mesh.scene_data({"subdivisions": 1})
    ref = check.reference_of(cornell_mesh, data, config, "cpu")
    assert isinstance(ref.geo, pathtrace.Geometry)
    assert not hasattr(cornell_mesh, "reference")


@pytest.fixture(scope="module")
def field_bench(tmp_path_factory):
    """``BENCHMARK.json`` with a configuration of the field (the
    flagship's render keys) and a progressive cell of it."""
    path = tmp_path_factory.mktemp("field") / "field3.json"
    config = json.loads(open(spec.HERE + "/configs/cornell_mesh6.json").read())
    config.update(FIELD, name="field3", scene="instanced_field")
    path.write_text(json.dumps(config))
    bench = spec.load()
    bench["configs"].append({"name": "field3", "source": "a test",
                             "file": str(path), "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": CELL, "config": "field3",
                               "traffic": "progressive", "chips": 1,
                               "why": "a test"})
    return bench


def test_a_tiny_instanced_cell_is_correct(field_bench):
    res = _tiny.run_tiny(CELL, bench=field_bench)
    assert res["correct"], res["compared"]
    assert res["compared"]["median_gap"]["value"] <= 1e-5


def test_nudged_placements_in_the_timed_path_make_the_run_incorrect(
        field_bench, monkeypatch):
    """The port's instanced closest hit traces every placement moved by
    0.05 in x (its expanded clusters' inverse transforms). One placement
    of the nine, nudged alone, moves 3-8% of the pixels off, under
    ``off_share``'s limit of 0.1 (PERF.md, Open questions)."""
    from pathtracing_tpu_torch.models import scene as scene_mod

    plain, kernel = scene_mod._ROUTES[("trace", "instanced")]

    def nudged(clusters, inst, origin, direction, *args, **kwargs):
        xform = inst.xform.clone()
        xform[inst.inst_id > 0, 9] += 0.05
        return plain(clusters, inst._replace(xform=xform), origin,
                     direction, *args, **kwargs)

    monkeypatch.setitem(scene_mod._ROUTES, ("trace", "instanced"),
                        (nudged, kernel))
    res = _tiny.run_tiny(CELL, bench=field_bench)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("seed", [2**31 + 5, 3])
def test_the_bfloat16_control_fails_a_limit_on_the_field(field_bench, seed):
    nums = calibrate.control_numbers(field_bench, CELL, seed, 4, "cpu",
                                     overrides=_tiny.overrides(), pixels=64)
    limits = _tiny.limits()
    assert (nums["median_gap"] > limits["median_gap"]
            or nums["off_share"] > limits["off_share"]), nums
