"""The progressive loop's frames through the port's wavefront engine:
``wavefront.render_step`` (a pool of min(W·H, 2^20) path slots whose
dead slots are refilled in place each iteration) in place of the
megakernel's ``progressive.render_step``; the traffic's ``engine``
replaces the configuration's. The present, the snapshot of the checked
pixels at ``check_spp``, the answers, the check and its ``LIMITS`` are
the progressive loop's, by import: the wavefront's paths are the
megakernel's, (pixel, sample) for (pixel, sample)."""

from __future__ import annotations

import os
import time

from ptbench import drive, profiling, spec

_p = spec.module("loops", "progressive", os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
answers, compare, LIMITS = _p.answers, _p.compare, _p.LIMITS


def _step():
    from pathtracing_tpu_torch.models import wavefront

    return wavefront.render_step


def setup(cell):
    """One warm frame through the pool at the cell's own shapes (sample
    0), and the checked pixels on the device."""
    import torch

    from pathtracing_tpu_torch.models import progressive

    cell.config = dict(cell.config, engine=cell.traffic["engine"])
    cfg = drive.render_config(cell, cell.seed)
    state = progressive.init_state(cfg, device=cell.device)
    state = _step()(state, cell.scene, cell.camera, cfg)
    _p._present(state)
    pix = _p._check_pixels(cell.traffic, cell.config, cell.seed)
    ctx = {"cfg": cfg, "state": state, "snapshot": None,
           "check_spp": cell.traffic.get("check_spp", float("inf")),
           "pixels": torch.as_tensor(pix, device=state.accum.device)}
    _p._snap(ctx, state)
    return ctx


def window(cell, ctx, seconds: float) -> dict:
    """Frames until ``seconds`` have passed and the snapshot is taken, as
    the progressive loop's window runs them (with ``trace``: the engine's
    counts of every frame, a synchronise before each present, frames 2 to
    1 + ``profile_units`` profiled)."""
    step = _step()
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
            state = step(state, cell.scene, cell.camera, cfg, stats=st)
        if cell.trace:
            cell.sync()
            tp = time.perf_counter()
            with profiling.span("present"):
                _p._present(state)
            presents.append(time.perf_counter() - tp)
        else:
            _p._present(state)
        tb = time.perf_counter()
        frames.append(tb - ta)
        snapped = _p._snap(ctx, state)
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
