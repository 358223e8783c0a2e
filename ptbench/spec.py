"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``configs/<config>.json``) and the scene module it names
(``scenes/<scene>.py``), its traffic mix (``traffic/<traffic>.json``) and
the closed loop that mix names (``loops/<loop>.py``), and each metric's
reader (``metrics/<name>.py``). Adding a cell, a mix, a loop or a metric
is adding files and entries; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def read_json(root: str, rel: str) -> dict:
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def config_file(bench: dict, cell_entry: dict, root: str = ROOT) -> dict:
    return read_json(root, config_entry(bench, cell_entry["config"])["file"])


def traffic_path(traffic: str, root: str = ROOT) -> str:
    return os.path.join(root, "ptbench", "traffic", f"{traffic}.json")


def traffic_file(cell_entry: dict, root: str = ROOT) -> dict:
    with open(traffic_path(cell_entry["traffic"], root)) as f:
        return json.load(f)


def module_path(kind: str, name: str, root: str = ROOT) -> str:
    return os.path.join(root, "ptbench", kind, f"{name}.py")


def module(kind: str, name: str, root: str = ROOT):
    """The module ``<kind>/<name>.py`` under ``root``'s ``ptbench``:
    ``metrics`` (a metric's reader; its name may hold dots), ``loops``
    (a closed loop) or ``scenes`` (a scene's inputs). Loaded by path, so
    that a copy of the benchmark finds its own files."""
    path = module_path(kind, name, root)
    spec = importlib.util.spec_from_file_location(
        f"ptbench_{kind}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str, root: str = ROOT):
    return module("metrics", name, root)


def metric_beside(path: str, name: str):
    """The reader ``name`` of the benchmark that holds the reader file
    ``path``: for a reader that reads as another one does, under a name of
    its own (a cell whose end-to-end metric differs)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(path))))
    return metric_module(name, root)


def metrics_of(bench: dict, cell_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
    without a ``workloads`` key, and those that list the cell."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]
