"""Frame after frame, each ``spp`` samples through the port's
``progressive.render_step`` (the sample index continues across frames),
then the present: ``progressive.resolve``, ``utils.image.tonemap`` and the
copy of the 8-bit image to the host. A frame's time runs from issuing its
step to its image being on the host.

The check compares the accumulated radiance of ``check_pixels`` pixels
drawn from the seed, twice. A snapshot of those pixels, gathered on the
device after the present of the first frame whose accumulator holds
``check_spp`` samples, gives ``attempted``, ``failed`` and
``snapshot_off_share``: off pixels grow with the samples a pixel holds, so
a count at a fixed number of samples does not grow with the port's speed.
The window runs on until it has taken the snapshot. The final accumulator
gives ``median_gap`` and ``off_share``. A mix without ``check_spp``
snapshots the final accumulator."""

from __future__ import annotations

import time

import numpy as np
import torch

from ptbench import check, drive, profiling

LIMITS = {"median_gap": 3e-4, "off_share": 0.1, "snapshot_off_share": 0.1}


def _present(state):
    from pathtracing_tpu_torch.models import progressive
    from pathtracing_tpu_torch.utils.image import tonemap

    return tonemap(progressive.resolve(state)).cpu()


def _check_pixels(traffic, config, seed):
    w, h = config["width"], config["height"]
    return check.sample_pixels(seed, w * h, traffic["check_pixels"])


def _gather(ctx, state):
    """The checked pixels' sums, copied on the device (no host wait)."""
    return torch.index_select(state.accum.reshape(-1, 3), 0, ctx["pixels"])


def _snap(ctx, state):
    """Takes the snapshot once the accumulator holds ``check_spp``;
    whether the window may end."""
    if ctx["snapshot"] is None and state.spp >= ctx["check_spp"]:
        ctx["snapshot"] = (_gather(ctx, state), state.spp)
    return ctx["snapshot"] is not None or ctx["check_spp"] == float("inf")


def setup(cell):
    """One warm frame at the cell's own shapes (sample 0), and the checked
    pixels on the device."""
    from pathtracing_tpu_torch.models import progressive

    cfg = drive.render_config(cell, cell.seed)
    state = progressive.init_state(cfg, device=cell.device)
    state = progressive.render_step(state, cell.scene, cell.camera, cfg)
    _present(state)
    pix = _check_pixels(cell.traffic, cell.config, cell.seed)
    ctx = {"cfg": cfg, "state": state, "snapshot": None,
           "check_spp": cell.traffic.get("check_spp", float("inf")),
           "pixels": torch.as_tensor(pix, device=state.accum.device)}
    _snap(ctx, state)
    return ctx


def window(cell, ctx, seconds: float) -> dict:
    """Frames until ``seconds`` have passed and the snapshot is taken.
    With ``trace`` the engine's counts are collected in every frame, each
    frame synchronises between its step and its present (the ``present``
    span), and frames 2 to 1 + ``profile_units`` are profiled."""
    from pathtracing_tpu_torch.models import progressive

    cfg, state = ctx["cfg"], ctx["state"]
    w, h, spp = cfg.width, cfg.height, cfg.samples_per_step
    frames, presents = [], []
    stats = {} if cell.trace else None
    prof_stats, profile = None, None
    profiler = profiling.Profiler(cell.sync)
    t0 = time.perf_counter()
    while True:
        i = len(frames)
        if cell.trace and i == 1 and cell.profile_units:
            profiler.start()
            prof_stats = {}
        ta = time.perf_counter()
        with profiling.span("render"):
            st = prof_stats if prof_stats is not None else stats
            state = progressive.render_step(state, cell.scene, cell.camera,
                                            cfg, stats=st)
        if cell.trace:
            cell.sync()
            tp = time.perf_counter()
            with profiling.span("present"):
                _present(state)
            presents.append(time.perf_counter() - tp)
        else:
            _present(state)
        tb = time.perf_counter()
        frames.append(tb - ta)
        snapped = _snap(ctx, state)
        if prof_stats is not None and len(frames) == 1 + cell.profile_units:
            profile = profiler.stop()
            profile["samples"] = cell.profile_units * w * h * spp
            profile["counts"] = {k: int(v) for k, v in prof_stats.items()}
            for k, v in prof_stats.items():
                stats[k] = stats.get(k, 0) + v
            prof_stats = None
        if tb - t0 >= seconds and prof_stats is None and snapped:
            break
    window_s = time.perf_counter() - t0
    counts = None
    if stats is not None:
        counts = {k: int(v) for k, v in stats.items()}
        counts["samples"] = len(frames) * w * h * spp
    ctx["state"] = state
    return {"window_s": window_s, "samples": len(frames) * w * h * spp,
            "frame_ms": [f * 1e3 for f in frames],
            "present_ms": [p * 1e3 for p in presents], "counts": counts,
            "profile": profile}


def answers(cell, ctx) -> dict:
    """The radiance sum and the samples each pixel holds, and the
    snapshot of the checked pixels with its samples (without
    ``check_spp``: the final sums)."""
    state = ctx["state"]
    snap, snap_spp = ctx["snapshot"] or (_gather(ctx, state), state.spp)
    return {"seed": cell.seed, "accum": state.accum, "spp": int(state.spp),
            "snapshot": snap, "snapshot_spp": int(snap_spp)}


def compare(ref, answers, config, traffic, seed) -> dict:
    """``median_gap`` and ``off_share`` of the final sums on the sampled
    pixels; ``attempted``, ``failed`` and ``snapshot_off_share`` of the
    snapshot. The reference traces the snapshot's samples, then the rest,
    and adds the two parts."""
    pix = _check_pixels(traffic, config, seed)
    seed = answers["seed"]
    n = np.full(pix.size, answers["spp"], np.int64)
    first = answers["snapshot_spp"]
    n_first = np.full(pix.size, first, np.int64)
    accum = answers["accum"]
    pix_t = torch.as_tensor(pix, device=accum.device)
    prog = accum.reshape(-1, 3)[pix_t].to(ref.device, torch.float32)
    snap = answers["snapshot"].to(ref.device, torch.float32)
    ref.pick_order(seed, pix, n, prog)
    want_first = ref.sums(seed, pix, n_first)
    want = want_first + ref.sums(seed, pix, n - n_first, first=first)
    final = check.gap_numbers(prog, want,
                              torch.as_tensor(n, device=ref.device))
    at_snap = check.gap_numbers(snap, want_first,
                                torch.as_tensor(n_first, device=ref.device))
    return {"median_gap": final["median_gap"],
            "off_share": final["off_share"],
            "snapshot_off_share": at_snap["off_share"],
            "attempted": at_snap["attempted"], "failed": at_snap["failed"]}
