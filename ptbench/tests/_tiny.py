"""A cell of the benchmark shrunk to run on the CPU in seconds: the same
harness, generator, check and reference, over a 320-triangle icosphere,
with the port's plain torch traversal: 32x32 progressive frames, or
16x16 adaptive renders of four tiles, two a round, to 4 spp."""

import copy
import os
import time

from ptbench import run, spec

SEED = 2**33 + 1234567


def limits(loop="progressive"):
    return spec.module("loops", loop).LIMITS


def with_parked(bench, root=spec.ROOT):
    """``bench`` with the cells of ``ptbench/parked.json`` (measured, and
    taken out of ``BENCHMARK.json``) and their metrics added back."""
    bench = copy.deepcopy(bench)
    parked = spec.read_json(root, os.path.join("ptbench", "parked.json"))
    for key in ("workloads", "end_to_end", "per_layer"):
        bench[key] += parked[key]
    return bench


def overrides(side=32):
    return {"width": side, "height": side, "subdivisions": 2}


def traffic_overrides(cell, pixels=48):
    tiles = ({"tiles_per_round": 2, "budget_spp": 4}
             if cell.endswith("adaptive") else {})
    return dict(tiles, check_pixels=pixels)


def run_tiny(cell, seconds=None, trace=False, root=spec.ROOT, seed=SEED,
             bench=None):
    """A window of ``seconds`` (default: a few frames, or one adaptive
    render)."""
    adaptive = cell.endswith("adaptive")
    if seconds is None:
        seconds = 0.0 if adaptive else 0.3
    bench = bench or with_parked(spec.load(root), root)
    return run.run_cell(bench, cell, seed, seconds, trace, device="cpu",
                        overrides=overrides(side=16 if adaptive else 32),
                        root=root,
                        traffic_overrides=traffic_overrides(cell),
                        t_start=time.perf_counter())
