"""The control of the check: the plain reference put in the program's
place and computed in bfloat16 (the nearest precision below the float32
the configurations state), compared by the check's own numbers with the
float32 reference on the pixels a run of the cell samples. Both are built
as the check builds its reference (``check.reference_of``: the scene
module's own where it brings one).

    python3 -m ptbench.calibrate --workload <cell> --seeds 1,2,3 --spp <n>

``--spp`` is the samples each sampled pixel holds at the end of a run's
window (a progressive run's frames; an adaptive render's mean spp), or at
a progressive run's snapshot (its traffic's ``check_spp``: the control's
``off_share`` there is the upper reading of ``snapshot_off_share``). Prints
one JSON line per seed. The benchmark's runs never run it; its readings
set the upper end of each limit (PERF.md)."""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ptbench import check, spec


def control_numbers(bench, name, seed, spp, device, overrides=None,
                    pixels=None):
    """The check's numbers with the bfloat16 reference as the program, on
    the traffic's ``check_pixels`` pixels (or ``pixels``)."""
    entry = spec.cell(bench, name)
    config = spec.config_file(bench, entry)
    config.update(overrides or {})
    scene_mod = spec.module("scenes", config["scene"])
    data = scene_mod.scene_data(config)
    ref = check.reference_of(scene_mod, data, config, device)
    low = check.reference_of(scene_mod, data, config, device,
                             dtype=torch.bfloat16)
    pix = check.sample_pixels(seed, config["width"] * config["height"],
                              pixels or spec.traffic_file(entry)[
                                  "check_pixels"])
    n = np.full(pix.size, spp, np.int64)
    want, want2 = ref.sums(seed, pix, n, squares=True)
    got, got2 = low.sums(seed, pix, n, squares=True)
    n_t = torch.as_tensor(n, device=device)
    numbers = check.gap_numbers(got, want, n_t)
    gaps2 = check.pixel_gaps(got2, want2, n_t, 1e-4)
    numbers["m2_off_share"] = float((gaps2 > check.OFF_GAP).float().mean())
    return numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--spp", type=int, required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("ptbench.calibrate: no CUDA card", file=sys.stderr)
        return 1
    bench = spec.load()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        nums = control_numbers(bench, args.workload, seed, args.spp, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "spp": args.spp, "control": nums,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
