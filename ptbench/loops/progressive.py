"""Frame after frame, each ``spp`` samples through the port's
``progressive.render_step`` (the sample index continues across frames),
then the present: ``progressive.resolve``, ``utils.image.tonemap`` and the
copy of the 8-bit image to the host. A frame's time runs from issuing its
step to its image being on the host. The check compares the accumulated
radiance of ``check_pixels`` pixels drawn from the seed."""

from __future__ import annotations

import time

import numpy as np
import torch

from ptbench import check, drive, profiling

LIMITS = {"median_gap": 3e-4, "off_share": 0.1}


def _present(state):
    from pathtracing_tpu_torch.models import progressive
    from pathtracing_tpu_torch.utils.image import tonemap

    return tonemap(progressive.resolve(state)).cpu()


def setup(cell):
    """One warm frame at the cell's own shapes (sample 0)."""
    from pathtracing_tpu_torch.models import progressive

    cfg = drive.render_config(cell, cell.seed)
    state = progressive.init_state(cfg, device=cell.device)
    state = progressive.render_step(state, cell.scene, cell.camera, cfg)
    _present(state)
    return {"cfg": cfg, "state": state}


def window(cell, ctx, seconds: float) -> dict:
    """Frames until ``seconds`` have passed. With ``trace`` the engine's
    counts are collected in every frame, each frame synchronises between
    its step and its present (the ``present`` span), and frames 2 to
    1 + ``profile_units`` are profiled."""
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
        if prof_stats is not None and len(frames) == 1 + cell.profile_units:
            profile = profiler.stop()
            profile["samples"] = cell.profile_units * w * h * spp
            profile["counts"] = {k: int(v) for k, v in prof_stats.items()}
            for k, v in prof_stats.items():
                stats[k] = stats.get(k, 0) + v
            prof_stats = None
        if tb - t0 >= seconds and prof_stats is None:
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
    """The radiance sum and the samples each pixel holds."""
    state = ctx["state"]
    return {"seed": cell.seed, "accum": state.accum, "spp": int(state.spp)}


def compare(ref, answers, config, traffic, seed) -> dict:
    """Numbers of the window's accumulator on the sampled pixels."""
    w, h = config["width"], config["height"]
    pix = check.sample_pixels(seed, w * h, traffic["check_pixels"])
    spp = np.full(pix.size, answers["spp"], np.int64)
    accum = answers["accum"]
    pix_t = torch.as_tensor(pix, device=accum.device)
    prog = accum.reshape(-1, 3)[pix_t].to(ref.device, torch.float32)
    ref.pick_order(answers["seed"], pix, spp, prog)
    want = ref.sums(answers["seed"], pix, spp)
    return check.gap_numbers(prog, want,
                             torch.as_tensor(spp, device=ref.device))
