"""The time and peak memory of the plain reference's sums at a scene's
size, where no configuration file holds that scene yet: the check's part
of a run, before a cell commits to the scene.

    python3 -m ptbench.reftime --config ptbench/configs/cornell_mesh6.json \\
        --set scene=instanced_field grid=64 subdivisions=6 radius=0.45 \\
        spacing=1.5 placement_seed=7 --pixels 1024 --spp 256 --seed 7

``--config`` gives the render keys, ``--set`` replaces or adds keys
(numbers are read as JSON). The reference is built as the check builds it
(``check.reference_of``) and sums ``--spp`` samples of ``--pixels``
pixels drawn from ``--seed``. Prints one JSON line. Needs a CUDA card."""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ptbench import check, spec


def parse_sets(items):
    out = {}
    for item in items:
        key, value = item.split("=", 1)
        try:
            out[key] = json.loads(value)
        except json.JSONDecodeError:
            out[key] = value
    return out


def time_sums(config, pixels, spp, seed, device, dtype=torch.float32):
    """The seconds to build the reference of ``config`` (``build_s``) and
    to sum ``spp`` samples of ``pixels`` drawn pixels (``sums_s``), with
    the share of those pixels found lit."""
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    scene_mod = spec.module("scenes", config["scene"])
    t0 = time.perf_counter()
    data = scene_mod.scene_data(config)
    ref = check.reference_of(scene_mod, data, config, device, dtype=dtype)
    sync()
    build_s = time.perf_counter() - t0
    pix = check.sample_pixels(seed, config["width"] * config["height"],
                              pixels)
    t0 = time.perf_counter()
    sums = ref.sums(seed, pix, np.full(pix.size, spp, np.int64))
    sync()
    sums_s = time.perf_counter() - t0
    lit = float((sums.amax(dim=1) > 0).float().mean())
    return {"build_s": build_s, "sums_s": sums_s, "pixels": int(pix.size),
            "spp": spp, "lit_share": lit,
            "finite": bool(torch.isfinite(sums).all())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--set", nargs="*", default=[])
    p.add_argument("--pixels", type=int, default=1024)
    p.add_argument("--spp", type=int, default=256)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("ptbench.reftime: no CUDA card", file=sys.stderr)
        return 1
    with open(args.config) as f:
        config = json.load(f)
    config.update(parse_sets(args.set))
    torch.cuda.reset_peak_memory_stats()
    out = time_sums(config, args.pixels, args.spp, args.seed, "cuda",
                    getattr(torch, args.dtype))
    out.update(memory_peak_bytes=torch.cuda.max_memory_allocated(),
               device=torch.cuda.get_device_name(0), dtype=args.dtype,
               set=parse_sets(args.set))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
