"""Back-to-back ``adaptive.render_adaptive_tiles`` renders of the frame,
render i with a seed derived from the run's seed and i (``tile``,
``tiles_per_round``, ``warmup_spp``, ``budget_spp`` and ``spp_per_round``
from the traffic mix). The window holds whole renders only: it closes at
the end of the render during which ``--seconds`` passed, so that every run
weighs the warmup waves and the greedy rounds alike. A render's samples
are the tile samples it spent.

The scheduler's ``progress`` callback (after each warmup spp, then after
each group of greedy rounds) synchronises, reads the clock and keeps, for
the check, the state it saw. The check compares each render's radiance
and squared sums on ``check_pixels`` pixels drawn from the seed, the
greedy picks (``reference/schedule.py`` applied to each state a callback
saw) and the books of tile spp against the reported spend. The picks
follow the program from its own state (the reference cannot replay every
round without rendering every tile); the radiance of each sampled tile is
checked from scratch.

The cell that runs this loop, ``cornell_mesh6.adaptive``, is parked in
``ptbench/parked.json``: its rate follows the host's speed past any bound
the benchmark may set (PERF.md). Its entries bring it back unchanged."""

from __future__ import annotations

import sys
import time

import torch

from ptbench import check, drive, profiling
from ptbench.reference import schedule

LIMITS = {"median_gap": 3e-4, "off_share": 0.1, "m2_off_share": 0.1,
          "picks_missed": 0, "books_off": 0}


def _kwargs(traffic: dict) -> dict:
    return {k: traffic[k] for k in ("tile", "tiles_per_round", "warmup_spp",
                                    "budget_spp", "spp_per_round")}


def setup(cell):
    """One short render at the cell's shapes: the warmup waves and one
    group of greedy rounds (a budget of ``warmup_spp`` + 1)."""
    from pathtracing_tpu_torch.models import adaptive

    kw = _kwargs(cell.traffic)
    kw["budget_spp"] = kw["warmup_spp"] + 1
    cfg = drive.render_config(cell, drive.render_seed(cell.seed, 0))
    adaptive.render_adaptive_tiles(cell.scene, cell.camera, cfg, **kw)
    cell.sync()
    return {"renders": []}


def window(cell, ctx, seconds: float) -> dict:
    """Whole renders until one ends past ``seconds``. ``round_ms`` holds
    each unprofiled greedy group's host time per round. With ``trace`` the
    first greedy group of the first render is profiled."""
    from pathtracing_tpu_torch.models import adaptive

    kw = _kwargs(cell.traffic)
    tile = kw["tile"]
    n_tiles = (cell.config["width"] // tile) * (cell.config["height"] // tile)
    warm_spent = min(kw["warmup_spp"], kw["budget_spp"]) * n_tiles
    k_spr = kw["tiles_per_round"] * kw["spp_per_round"]
    profiling_due = cell.trace and cell.profile_units
    profiler = profiling.Profiler(cell.sync)
    renders = ctx["renders"]
    out = {"profile": None}
    rounds = []
    last = {}   # the render's last callback: spend, end time, profiled

    def progress(state, spent, budget):
        cell.sync()
        now = time.perf_counter()
        n_rounds = (int(spent) - last["spent"]) // k_spr
        if last["spent"] >= warm_spent and n_rounds and not last["profiled"]:
            rounds.append((now - last["t"]) * 1e3 / n_rounds)
        r = renders[-1]
        r["snapshots"].append({
            "spent": int(spent), "tile_spp": state.tile_spp.clone(),
            "accum": state.accum.clone(), "m2": state.m2.clone()})
        on = False
        if profiling_due and len(renders) == 1 and spent >= warm_spent:
            if not profiler.prof:
                profiler.start()
                out["from"] = int(spent)
                on = True
            elif out["profile"] is None:
                out["profile"] = profiler.stop()
                out["profile"]["samples"] = (
                    (int(spent) - out["from"]) * tile * tile)
        last.update(spent=int(spent), t=time.perf_counter(), profiled=on)

    spent = 0
    t0 = t_render = time.perf_counter()
    render_s = []
    while True:
        seed = drive.render_seed(cell.seed, len(renders))
        cfg = drive.render_config(cell, seed)
        renders.append({"seed": seed, "snapshots": []})
        last.update(spent=0, t=time.perf_counter(), profiled=False)
        with profiling.span("render"):
            adaptive.render_adaptive_tiles(cell.scene, cell.camera, cfg,
                                           progress=progress, **kw)
        cell.sync()
        spent += renders[-1]["snapshots"][-1]["spent"]
        render_s.append(time.perf_counter() - t_render)
        t_render = time.perf_counter()
        if time.perf_counter() - t0 >= seconds and (
                not profiling_due or out["profile"] is not None):
            break
    window_s = time.perf_counter() - t0
    print("ptbench: renders " + ", ".join(f"{s:.3f}" for s in render_s)
          + " s", file=sys.stderr)
    return {"window_s": window_s, "samples": spent * tile * tile,
            "round_ms": rounds, "profile": out["profile"]}


def answers(cell, ctx) -> dict:
    return {"renders": ctx["renders"]}


def _tile_of(pix, w, tile):
    py, px = pix // w, pix % w
    return (py // tile) * (w // tile) + px // tile, py % tile, px % tile


def compare(ref, answers, config, traffic, seed) -> dict:
    """Numbers of the window's renders."""
    tile, k = traffic["tile"], traffic["tiles_per_round"]
    w, h = config["width"], config["height"]
    n_tiles = (w // tile) * (h // tile)
    warm = min(traffic["warmup_spp"], traffic["budget_spp"]) * n_tiles
    budget = traffic["budget_spp"] * n_tiles
    sums, gaps2 = [[], [], []], []
    missed = books = 0
    for i, r in enumerate(answers["renders"]):
        snaps = r["snapshots"]
        last = snaps[-1]
        pix = check.sample_pixels(seed, w * h, traffic["check_pixels"],
                                  salt=i)
        t_id, ty, tx = _tile_of(torch.as_tensor(pix), w, tile)
        spp = last["tile_spp"].cpu()[t_id].long()
        idx = tuple(x.to(last["accum"].device) for x in (t_id, ty, tx))
        prog = last["accum"][idx].to(ref.device, torch.float32)
        prog2 = last["m2"][idx].to(ref.device, torch.float32)
        if i == 0:
            ref.pick_order(r["seed"], pix, spp.numpy(), prog)
        want, want2 = ref.sums(r["seed"], pix, spp.numpy(), squares=True)
        spp_d = spp.to(ref.device)
        for lst, x in zip(sums, (prog, want, spp_d)):
            lst.append(x)
        gaps2.append(check.pixel_gaps(prog2, want2, spp_d, 1e-4))
        for s in snaps:
            if s["spent"] <= warm:
                # The warmup renders every tile alike, a spp at a time.
                books += int((s["tile_spp"] != s["spent"] // n_tiles).sum())
        for a, b in zip(snaps, snaps[1:]):
            if a["spent"] >= warm:
                missed += schedule.picks_missed(
                    a["accum"], a["m2"], a["tile_spp"], b["tile_spp"], k)
            books += abs(int((b["tile_spp"] - a["tile_spp"]).sum())
                         - (b["spent"] - a["spent"]))
        books += abs(int(last["tile_spp"].sum()) - last["spent"])
        books += max(0, last["spent"] - budget)
    numbers = check.gap_numbers(*(torch.cat(x) for x in sums))
    numbers.update(
        m2_off_share=float((torch.cat(gaps2) > check.OFF_GAP).float().mean()),
        picks_missed=missed, books_off=books)
    return numbers
