"""A cell of the benchmark shrunk to run on the CPU in seconds: the same
harness, generator, check and reference, over a 320-triangle icosphere,
with the port's plain torch traversal: 32x32 progressive frames, or
16x16 adaptive renders of four tiles, two a round, to 4 spp."""

import copy
import os
import time

from ptbench import run, spec

SEED = 2**33 + 1234567
CHECK_SPP = 2


def limits(loop="progressive"):
    return spec.module("loops", loop).LIMITS


def with_parked(bench, root=spec.ROOT):
    """``bench`` with the cells of ``ptbench/parked.json`` (measured, and
    taken out of ``BENCHMARK.json``) and their metrics added back: each
    cell also joins the ``workloads`` of the metrics it is
    ``reported_by``."""
    bench = copy.deepcopy(bench)
    parked = spec.read_json(root, os.path.join("ptbench", "parked.json"))
    for key in ("workloads", "end_to_end", "per_layer"):
        bench[key] += parked[key]
    for cell, names in parked.get("reported_by", {}).items():
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] in names:
                m["workloads"].append(cell)
    return bench


def overrides(side=32):
    return {"width": side, "height": side, "subdivisions": 2}


def traffic_overrides(cell, pixels=48):
    """The traffic's keys a tiny run replaces: fewer checked pixels, fewer
    tiles, and the frames' snapshot a few frames in."""
    tiles = ({"tiles_per_round": 2, "budget_spp": 4}
             if cell.endswith("adaptive") else {})
    frames = ({"check_spp": CHECK_SPP}
              if cell.endswith((".progressive", ".wavefront")) else {})
    return dict(tiles, **frames, check_pixels=pixels)


def run_tiny(cell, seconds=None, trace=False, root=spec.ROOT, seed=SEED,
             bench=None, traffic=None):
    """A window of ``seconds`` (default: a few frames, or one adaptive
    render); ``traffic`` replaces keys of ``traffic_overrides``."""
    adaptive = cell.endswith("adaptive")
    if seconds is None:
        seconds = 0.0 if adaptive else 0.3
    bench = bench or with_parked(spec.load(root), root)
    return run.run_cell(bench, cell, seed, seconds, trace, device="cpu",
                        overrides=overrides(side=16 if adaptive else 32),
                        root=root,
                        traffic_overrides=dict(traffic_overrides(cell),
                                               **(traffic or {})),
                        t_start=time.perf_counter())


def recording_answers(monkeypatch):
    """A list that gets each run's ``answers`` (the loop module is loaded
    anew for every run, so the wrapper goes in where it is looked up)."""
    seen = []
    real = spec.module

    def module(kind, name, root=spec.ROOT):
        mod = real(kind, name, root)
        if kind == "loops":
            answers = mod.answers

            def kept(cell, ctx):
                seen.append(answers(cell, ctx))
                return seen[-1]

            mod.answers = kept
        return mod

    monkeypatch.setattr(spec, "module", module)
    return seen


def run_until(cell, seen, spp, **kwargs):
    """A tiny progressive run whose window ends holding ``spp`` samples or
    more: its seconds doubled until it does. Returns the result and the
    run's answers (``seen`` from ``recording_answers``)."""
    seconds = 1.0
    while True:
        res = run_tiny(cell, seconds=seconds, **kwargs)
        if seen[-1]["spp"] >= spp or seconds > 30:
            return res, seen[-1]
        seconds *= 2
