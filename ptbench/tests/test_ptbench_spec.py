"""``BENCHMARK.json`` against the benchmark's contract, and the harness's
data-driven lookup (CPU)."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from ptbench import spec
from ptbench.tests import _tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(params=["benchmark", "with_parked"])
def bench(request):
    """``BENCHMARK.json``, and the same with the parked cells added back:
    a parked cell has to meet the contract too."""
    b = spec.load()
    return b if request.param == "benchmark" else _tiny.with_parked(b)


def test_names_and_units_use_allowed_characters(bench):
    b = bench
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            assert UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}


LOOP = ("setup", "window", "answers", "compare", "LIMITS")


def test_every_cell_finds_its_files_by_name(bench):
    b = bench
    for w in b["workloads"]:
        cfg = spec.config_file(b, w)
        assert os.path.exists(spec.traffic_path(w["traffic"]))
        traffic = spec.traffic_file(w)
        loop = spec.module("loops", traffic["loop"])
        assert all(hasattr(loop, a) for a in LOOP) and loop.LIMITS
        assert traffic["check_pixels"] > 0
        assert hasattr(spec.module("scenes", cfg["scene"]), "build_port")
        for kind in ("end_to_end", "per_layer"):
            for m in spec.metrics_of(b, w["name"], kind):
                assert hasattr(spec.metric_module(m["name"]), "read")


def test_each_moves_metric_is_reported_in_each_cell_of_its_metric(bench):
    b = bench
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = [w["name"] for w in b["workloads"]]
    for m in b["per_layer"]:
        moved = e2e[m["moves"]]
        for c in m.get("workloads", cells):
            assert c in cells
            assert c in moved.get("workloads", cells), (m["name"], c)
    for c in cells:
        assert len(spec.metrics_of(b, c, "end_to_end")) >= 2
        assert spec.metrics_of(b, c, "per_layer")


def test_run_loads_no_jax_nor_the_jax_package():
    """A process that imports the harness, loads each traffic mix and its
    loop and runs a tiny progressive window on the CPU holds no module
    whose top-level name is jax, jaxlib, flax, pathtracing_tpu or
    benchmarks."""
    code = (
        "import json, sys\n"
        "from ptbench import run, spec, drive, check\n"
        "from ptbench.tests import _tiny\n"
        "b = _tiny.with_parked(spec.load())\n"
        "for w in b['workloads']:\n"
        "    spec.module('loops', spec.traffic_file(w)['loop'])\n"
        "_tiny.run_tiny('cornell_mesh6.progressive', seconds=0.1)\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


# A closed loop of its own: the progressive loop's frames, two at most.
TWO_FRAMES = """
from ptbench import spec

_p = spec.module("loops", "progressive")
setup, answers, compare, LIMITS = _p.setup, _p.answers, _p.compare, _p.LIMITS


def window(cell, ctx, seconds):
    run = _p.window(cell, ctx, 0.0)
    if run["samples"] == 2 * cell.config["width"] * cell.config["height"]:
        return run
    run2 = _p.window(cell, ctx, 0.0)
    run2["frame_ms"] = run["frame_ms"] + run2["frame_ms"]
    run2["samples"] += run["samples"]
    run2["window_s"] += run["window_s"]
    return run2
"""


def test_a_new_config_traffic_loop_and_metric_need_only_files(tmp_path):
    """A dummy configuration, two traffic mixes (one of them with a closed
    loop of its own) and a metric, added as files and entries to a copy of
    the benchmark, run without touching its code."""
    root = tmp_path / "repo"
    root.mkdir()
    shutil.copytree(os.path.join(spec.ROOT, "ptbench"), root / "ptbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = spec.load()
    cfg = json.load(open(os.path.join(spec.HERE, "configs",
                                      "cornell_mesh6.json")))
    cfg["subdivisions"] = 1
    json.dump(cfg, open(root / "ptbench/configs/dummy_box.json", "w"))
    json.dump({"loop": "progressive", "spp": 2, "check_pixels": 16},
              open(root / "ptbench/traffic/two_spp.json", "w"))
    json.dump({"loop": "two_frames", "spp": 1, "check_pixels": 16},
              open(root / "ptbench/traffic/two_frames.json", "w"))
    (root / "ptbench/loops/two_frames.py").write_text(TWO_FRAMES)
    (root / "ptbench/metrics/frames_seen.py").write_text(
        "def read(run):\n    return len(run['frame_ms'])\n")
    b["configs"].append({"name": "dummy_box", "source": "a test",
                         "file": "ptbench/configs/dummy_box.json",
                         "reduced": [], "why": "a test"})
    cells = ["dummy_box.two_spp", "dummy_box.two_frames"]
    for c in cells:
        b["workloads"].append({"name": c, "config": "dummy_box",
                               "traffic": c.split(".")[1], "chips": 1,
                               "why": "a test"})
    for m in b["end_to_end"]:
        if m["name"] == "msamples_per_s":
            m["workloads"] += cells
    b["end_to_end"].append({"name": "frames_seen", "unit": "frames",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock", "workloads": cells})
    json.dump(b, open(root / "BENCHMARK.json", "w"))
    res = _tiny.run_tiny(cells[0], seconds=0.1, root=str(root))
    assert res["correct"], res["compared"]
    assert res["metrics"]["frames_seen"]["value"] >= 1
    assert set(res["metrics"]) == {"msamples_per_s", "setup_s",
                                   "frames_seen"}
    res = _tiny.run_tiny(cells[1], seconds=30.0, root=str(root))
    assert res["correct"], res["compared"]
    assert res["metrics"]["frames_seen"]["value"] == 2
