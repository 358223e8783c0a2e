"""Wavefront path-tracing engine (the JAX package's ``models/wavefront.py``):
a persistent pool of paths with in-place regeneration.

A fixed pool of N path slots lives on the device. Each iteration (1)
refills the dead slots with fresh camera samples from the global
pixel-major (pixel, sample) stream, each dead slot taking the stream
index of its rank among the dead slots (an exclusive cumsum, so live
paths never move); (2) runs one ``shading.bounce_batch`` over the whole
pool with per-slot depth counters, so camera and bounce rays share one
wave; (3) deposits the radiance of the paths that ended into the image.
The loop runs until the stream is used up and the pool has drained, so
the traversal work follows the path segments actually traced.

Paths are keyed by (seed, pixel, sample) as in the megakernel
(``shading.camera_sample``), so each path's estimate is the megakernel's
bit for bit; only the order in which estimates reach the image differs.
The deposit adds each pixel's estimates in slot order (the order of the
JAX package's scatter-add on the CPU), the same on every device.

Beside the JAX pool's fields, a slot keeps what its refill computed for
the whole path: its key, the first vertex's low-discrepancy draws and its
shutter time. The JAX package recomputes them from (pixel, sample) every
iteration; the values are the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pathtracing_tpu_torch.models import scene as scene_mod
from pathtracing_tpu_torch.models import shading
from pathtracing_tpu_torch.models.progressive import RenderState
from pathtracing_tpu_torch.ops import rng
from pathtracing_tpu_torch.utils import metrics
from pathtracing_tpu_torch.utils.config import RenderConfig


class PathPool(NamedTuple):
    """The state of N in-flight paths (every tensor has N rows)."""

    origin: torch.Tensor      # (N, 3) f32
    direction: torch.Tensor   # (N, 3) f32
    radiance: torch.Tensor    # (N, 3) f32 running estimate
    throughput: torch.Tensor  # (N, 3) f32
    pixel: torch.Tensor       # (N,) i64 flat pixel id
    sample: torch.Tensor      # (N,) i64 global sample index
    depth: torch.Tensor       # (N,) i64 bounce counter
    active: torch.Tensor      # (N,) bool
    prev_pdf: torch.Tensor    # (N,) f32 BSDF pdf at the previous vertex
    prev_nee: torch.Tensor    # (N,) bool previous vertex sampled NEE
    keys: torch.Tensor        # (N, 2) i64 per-path key
    # (N, 3) interior sigma_a (scenes with mat_absorb), (N, 2) interior
    # scattering row (scenes with mat_interior), (N,) ray-cone distance
    # (scenes with mips); None otherwise.
    medium: torch.Tensor = None
    sss: torch.Tensor = None
    cone: torch.Tensor = None
    # First-vertex LD draws (N, 3) / (N, 2) under the LD sampler, and the
    # (N,) shutter time of scenes with motion; None otherwise.
    ld_nee: torch.Tensor = None
    ld_scatter: torch.Tensor = None
    time: torch.Tensor = None


def _empty_pool(n: int, device, has_media=False, has_sss=False,
                has_mips=False, ld=False, motion=False) -> PathPool:
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return PathPool(
        origin=zeros(n, 3), direction=zeros(n, 3), radiance=zeros(n, 3),
        throughput=torch.ones((n, 3), dtype=torch.float32, device=device),
        pixel=zeros(n, dtype=torch.int64), sample=zeros(n, dtype=torch.int64),
        depth=zeros(n, dtype=torch.int64), active=zeros(n, dtype=torch.bool),
        prev_pdf=zeros(n), prev_nee=zeros(n, dtype=torch.bool),
        keys=zeros(n, 2, dtype=torch.int64),
        medium=zeros(n, 3) if has_media else None,
        sss=zeros(n, 2) if has_sss else None,
        cone=zeros(n) if has_mips else None,
        ld_nee=zeros(n, 3) if ld else None,
        ld_scatter=zeros(n, 2) if ld else None,
        time=zeros(n) if motion else None,
    )


def pool_size(config: RenderConfig) -> int:
    """Pool capacity: ``config.wavefront_pool`` when set, else one slot per
    pixel up to 2^20."""
    if getattr(config, "wavefront_pool", 0):
        return int(config.wavefront_pool)
    return min(config.width * config.height, 1 << 20)


def _fill(idx, fills):
    """``x[idx] = value`` for each (x, value): a Python scalar set at
    tensor indices is copied to the device first, a blocking copy each."""
    for x, value in fills:
        x[idx] = value


def _refill(pool: PathPool, n_take: int, next_path: int, camera,
            config: RenderConfig, seed: int, sample_start: int):
    """Fill the first ``n_take`` dead slots (in slot order) with the
    stream's paths ``next_path``, ``next_path + 1``, ...; in place."""
    npix = config.width * config.height
    dead = ~pool.active
    rank = torch.cumsum(dead, 0) - dead.to(torch.int64)
    idx = metrics.host_read("wavefront.refill", torch.nonzero,
                            dead & (rank < n_take)).squeeze(1)
    stream = next_path + rank[idx]
    pixel = stream % npix
    sample = sample_start + stream // npix
    keys, o, d = shading.camera_sample(camera, config, seed, pixel, sample)
    pool.origin[idx] = o
    pool.direction[idx] = d
    pool.pixel[idx] = pixel
    pool.sample[idx] = sample
    pool.keys[idx] = keys
    fills = [(pool.radiance, 0.0), (pool.throughput, 1.0), (pool.depth, 0),
             (pool.active, True), (pool.prev_pdf, 0.0),
             (pool.prev_nee, False)]
    fills += [(x, 0.0) for x in (pool.medium, pool.sss, pool.cone)
              if x is not None]
    metrics.host_read("wavefront.refill", _fill, idx, fills,
                      syncs=len(fills))
    if pool.ld_nee is not None:
        pick = rng.ld_scalar(seed, pixel, sample, rng.STREAM_NEE)
        pool.ld_nee[idx] = torch.stack(
            [pick, *rng.ld_pair(seed, pixel, sample, rng.STREAM_NEE)], dim=1)
        pool.ld_scatter[idx] = torch.stack(
            rng.ld_pair(seed, pixel, sample, rng.STREAM_SCATTER), dim=1)
    if pool.time is not None:
        # The draw a moving camera took in camera_sample.
        pool.time[idx] = shading.shutter_time(config, seed, pixel, sample,
                                              keys)


def _deposit(accum_flat, pixel, value, unique: bool):
    """accum[pixel[i]] += value[i], each pixel's values added in the order
    given. ``unique``: no pixel repeats, one indexed add."""
    if unique:
        accum_flat.index_add_(0, pixel, value)
        return
    pix, order = torch.sort(pixel, stable=True)
    value = value[order]
    pos = torch.arange(pix.shape[0], device=pix.device)
    new = torch.ones_like(pix, dtype=torch.bool)
    new[1:] = pix[1:] != pix[:-1]
    rank = pos - torch.cummax(torch.where(new, pos, 0), 0).values
    n_ranks = (metrics.host_read("wavefront.deposit", int, rank.max()) + 1
               if pix.numel() else 0)
    for k in range(n_ranks):
        sel = rank == k
        accum_flat.index_add_(0, *metrics.host_read(
            "wavefront.deposit", metrics.masked, sel, pix, value, syncs=2))


def render_wave(scene, camera, config: RenderConfig, accum_flat,
                sample_start: int, n_samples: int, seed: int, stats=None):
    """Trace ``n_samples`` spp through the pool, adding into ``accum_flat``
    ((H·W, 3), in place). Returns (accum_flat, segments): the live slots
    of every iteration plus the shadow rays traced (an int).

    ``sample_start`` continues the progressive sample sequence; the stream
    is pixel-major (every pixel at sample k before k + 1). ``stats``
    (optional dict) accumulates ``segments`` (live slots entering a
    bounce), ``shadow_segments``, ``iterations`` and ``slots`` (pool
    slots over the iterations, the occupancy's denominator)."""
    npix = config.width * config.height
    n = pool_size(config)
    total = npix * n_samples
    dev = accum_flat.device
    traversal = config.resolve_traversal(scene)
    has_media = scene.mat_absorb is not None
    has_sss = scene.mat_interior is not None
    has_mips = scene_mod.uses_mips(scene)
    pool = _empty_pool(n, dev, has_media=has_media, has_sss=has_sss,
                       has_mips=has_mips, ld=config.sampler == "ld",
                       motion=scene_mod.has_motion(scene))
    spread = shading.cone_spread_of(camera, config) if has_mips else None
    count_shadow = config.nee and scene.lights is not None
    next_path = n_active = iterations = live_segments = 0
    shadow = torch.zeros((), dtype=torch.int64, device=dev)
    while next_path < total or n_active > 0:
        n_dead = n - n_active
        n_take = min(n_dead, total - next_path)
        if n_take > 0:
            _refill(pool, n_take, next_path, camera, config, seed,
                    sample_start)
        next_path = min(next_path + n_dead, total)
        live_segments += n_active + n_take

        with metrics.span("engine.bounce"):
            out = shading.bounce_batch(
                scene, pool.origin, pool.direction, pool.keys, pool.depth,
                pool.radiance, pool.throughput, pool.active,
                config.rr_start_depth, config.background, traversal,
                nee=config.nee, prev_pdf=pool.prev_pdf,
                prev_nee=pool.prev_nee, bin_rays=config.ray_sort,
                return_shadow_count=True, ld_nee=pool.ld_nee,
                ld_scatter=pool.ld_scatter, medium=pool.medium,
                sss=pool.sss, time=pool.time, cone=pool.cone,
                cone_spread=spread, nee_candidates=config.nee_candidates,
            )
        radiance, throughput, o, d, active, pdf, pdiff = out[:7]
        # Decoded by the scene's flags, never by the tuple's length.
        rest = 7
        medium = out[rest] if has_media else None
        rest += has_media
        sss = out[rest] if has_sss else None
        rest += has_sss
        cone = out[rest] if has_mips else None
        if count_shadow:
            shadow += out[-1]
        depth = pool.depth + 1
        active = active & (depth < config.max_depth)

        # Paths that ended deposit once and zero their estimate.
        finished = metrics.host_read("wavefront.finished", torch.nonzero,
                                     pool.active & ~active).squeeze(1)
        value = radiance[finished]
        if config.clamp > 0.0:
            value = torch.clamp(value, max=config.clamp)
        _deposit(accum_flat, pool.pixel[finished], value,
                 unique=n_samples == 1)
        metrics.host_read("wavefront.finished", radiance.__setitem__,
                          finished, 0.0)
        pool = pool._replace(
            origin=o, direction=d, radiance=radiance, throughput=throughput,
            depth=depth, active=active, prev_pdf=pdf, prev_nee=pdiff,
            medium=medium, sss=sss, cone=cone)
        n_active = metrics.host_read("wavefront.live", int, active.sum())
        iterations += 1
    shadow = metrics.host_read("wavefront.shadow", int, shadow)
    if stats is not None:
        stats["segments"] = stats.get("segments", 0) + live_segments
        stats["shadow_segments"] = stats.get("shadow_segments", 0) + shadow
        stats["iterations"] = stats.get("iterations", 0) + iterations
        stats["slots"] = stats.get("slots", 0) + iterations * n
    return accum_flat, live_segments + shadow


def render_step(state: RenderState, scene, camera, config: RenderConfig,
                stats=None) -> RenderState:
    """One progressive step through the wavefront engine (drop-in for
    ``progressive.render_step``): ``state.accum`` is updated in place.
    One step is one ``engine.step`` span (``utils.metrics``)."""
    h, w = config.height, config.width
    with metrics.step():
        render_wave(scene, camera, config, state.accum.view(h * w, 3),
                    sample_start=state.spp,
                    n_samples=config.samples_per_step, seed=state.seed,
                    stats=stats)
    return RenderState(accum=state.accum,
                       spp=state.spp + config.samples_per_step,
                       seed=state.seed)


def count_segments(scene, camera, config: RenderConfig, seed) -> int:
    """Segments traced for one step from sample 0 (live slots plus shadow
    rays): the bench's Mrays/s numerator."""
    h, w = config.height, config.width
    accum = torch.zeros((h * w, 3), dtype=torch.float32,
                        device=scene.tri_v0.device)
    return render_wave(scene, camera, config, accum, sample_start=0,
                       n_samples=config.samples_per_step, seed=int(seed))[1]
