"""Megakernel path-tracing integrator (the JAX package's
``models/megakernel.py``, block mode): every bounce of a sample over a
block of image rows, as one batched wave per bounce.

Forward path tracing with emissive-surface, environment and delta
lighting, NEE with MIS (optionally RIS light picks), BSDF sampling and
Russian roulette from ``rr_start_depth``, participating media (fog, a
voxel grid, interior scattering). Scenes with absorbing dielectrics
(``mat_absorb``) carry each path's interior medium in the state, scenes
with scattering dielectrics (``mat_interior``) its interior scattering
row, and scenes with a texture mip pyramid its distance from the camera
(the ray cone). With ``config.ray_sort`` a scene that walks the cluster
tree takes each query's rays in (cell, octant) bins. A moving camera is
an ``(open, close)`` pair traced at each path's shutter time, the draw
that object motion uses.
Pixel and sample ids are global, so any chunking of the rows gives the
same per-pixel results bit for bit. Besides contiguous row blocks it
renders the adaptive schedulers' waves: scattered image rows, each at its
own sample counter (``rows=``), and scattered pixels (``pixels=``); a
pixel's k-th sample is the same in every mode.
"""

from __future__ import annotations

import torch

from pathtracing_tpu_torch.models import scene as scene_mod
from pathtracing_tpu_torch.models import shading
from pathtracing_tpu_torch.ops import binning, cluster_trace, rng
from pathtracing_tpu_torch.utils import metrics
from pathtracing_tpu_torch.utils.config import RenderConfig

# Ceiling on rays per bounce wave. The JAX package's 1 << 18 exists for a
# TPU tile-padding reason; on an 80 GB card a whole 1920x1080 frame
# (2,073,600 rays) fits one wave. Chunking never changes a pixel's result.
MAX_WAVE_RAYS = 1 << 21

# Depths at which surviving paths are compacted live-first (a stable
# 2-bin permutation of the per-path state). Waves after it trace only
# the live prefix — dead lanes' radiance never changes again — and the
# inverse permutation restores pixel order at the end: a pure
# reordering, so per-path results are unchanged.
COMPACT_DEPTHS = (3,)


def _chunking(n_units: int, unit_rays: int):
    """(chunk_units, n_chunks) for a wave of ``n_units`` units of
    ``unit_rays`` rays (image rows of W pixels, or single pixels): the
    largest divisor of ``n_units`` whose wave fits MAX_WAVE_RAYS, or
    ceil-splitting at the cap (padded last chunk) when no divisor reaches
    half the cap — the JAX rule."""
    if n_units * unit_rays <= MAX_WAVE_RAYS:
        return n_units, 1
    cap = max(1, MAX_WAVE_RAYS // unit_rays)
    divisor = max(c for c in range(1, cap + 1) if n_units % c == 0)
    chunk = divisor if 2 * divisor >= cap else cap
    return chunk, -(-n_units // chunk)


def render_samples(scene, camera, config: RenderConfig, sample_start,
                   n_samples: int, seed: int, row_start: int = 0,
                   block_rows=None, stats=None, sample_stride: int = 1,
                   rows=None, rows_sample_start=None, pixels=None,
                   pixels_sample_start=None):
    """Sum of ``n_samples`` radiance samples per pixel over rows
    [row_start, row_start + block_rows) (default the whole image):
    (block_rows, W, 3) float32.

    ``sample_start`` (an int, or a 0-d integer tensor) is the global
    sample counter, so progressive steps continue the exact RNG sequence;
    sample ``i`` of this call is global sample ``sample_start +
    i * sample_stride`` (a stride lets several renders split the samples
    of one image). ``stats`` (optional dict) accumulates ``segments``
    (rays entering each bounce's closest-hit query) and
    ``shadow_segments`` (NEE shadow rays) as device tensors, and in a
    scene of the two-level instanced walk its ``placements_entered`` and
    ``proto_clusters_tested`` (``cluster_trace.WALK_COUNTS``).

    Scattered-rows mode: ``rows`` ((R,) integer tensor) names image rows
    and ``rows_sample_start`` ((R,)) gives each row its own sample
    counter; returns (R, W, 3) in ``rows`` order. Scattered-pixels mode:
    ``pixels`` ((R,)) names global pixel ids with per-pixel counters
    ``pixels_sample_start``; returns (R, 3). ``sample_start``,
    ``row_start`` and ``block_rows`` are unused in these modes."""
    if pixels is not None:
        if pixels_sample_start is None:
            raise ValueError("pixels mode needs pixels_sample_start")
        return _render_scattered(scene, camera, config, pixels.long(),
                                 pixels_sample_start.long(), 1, n_samples,
                                 seed, sample_stride, stats)
    if rows is not None:
        if rows_sample_start is None:
            raise ValueError("rows mode needs rows_sample_start")
        return _render_scattered(scene, camera, config, rows.long(),
                                 rows_sample_start.long(), config.width,
                                 n_samples, seed, sample_stride, stats)
    h, w = config.height, config.width
    block_rows = h if block_rows is None else block_rows
    chunk_rows, n_chunks = _chunking(block_rows, w)
    device = scene.tri_v0.device
    traversal = config.resolve_traversal(scene)
    ys = torch.arange(chunk_rows, dtype=torch.int64, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.int64, device=device)[None, :]

    accum = torch.zeros((block_rows, w, 3), dtype=torch.float32,
                        device=device)
    for sample_ofs in range(n_samples):
        sample_idx = sample_start + sample_ofs * sample_stride
        for ci in range(n_chunks):
            r0 = ci * chunk_rows
            pixel_index = ((ys + row_start + r0) * w + xs).reshape(-1)
            radiance = _trace_pixels(scene, camera, config, traversal,
                                     pixel_index, sample_idx, seed, stats)
            radiance = radiance.reshape(chunk_rows, w, 3)
            if config.clamp > 0.0:
                radiance = torch.clamp(radiance, max=config.clamp)
            # Padded rows of a ceil-split last chunk are dropped here.
            n = min(chunk_rows, block_rows - r0)
            accum[r0:r0 + n] += radiance[:n]
    return accum


def _render_scattered(scene, camera, config: RenderConfig, units,
                      unit_sample_start, width: int, n_samples: int,
                      seed: int, sample_stride: int, stats):
    """The scattered modes: ``units`` are image rows (``width`` = W) or
    global pixel ids (``width`` = 1), each at its own sample counter.
    Waves chunk at MAX_WAVE_RAYS as in block mode; a short tail chunk is
    padded with unit 0 at sample 0 and the padded results are dropped, so
    every wave of one call has the same shape. Returns (R, W, 3) for rows,
    (R, 3) for pixels."""
    n_units = units.shape[0]
    chunk, n_chunks = _chunking(n_units, width)
    pad = n_chunks * chunk - n_units
    if pad:
        zeros = torch.zeros(pad, dtype=torch.int64, device=units.device)
        units = torch.cat([units, zeros])
        unit_sample_start = torch.cat([unit_sample_start, zeros])
    traversal = config.resolve_traversal(scene)
    xs = torch.arange(width, dtype=torch.int64, device=units.device)
    accum = torch.zeros((n_units, width, 3), dtype=torch.float32,
                        device=units.device)
    for sample_ofs in range(n_samples):
        for ci in range(n_chunks):
            u0 = ci * chunk
            unit = units[u0:u0 + chunk]
            pixel_index = (unit[:, None] * width + xs[None, :]).reshape(-1)
            sample_idx = torch.repeat_interleave(
                unit_sample_start[u0:u0 + chunk]
                + sample_ofs * sample_stride, width)
            radiance = _trace_pixels(scene, camera, config, traversal,
                                     pixel_index, sample_idx, seed, stats)
            radiance = radiance.reshape(chunk, width, 3)
            if config.clamp > 0.0:
                radiance = torch.clamp(radiance, max=config.clamp)
            n = min(chunk, n_units - u0)
            accum[u0:u0 + n] += radiance[:n]
    return accum[:, 0] if width == 1 else accum


# Per-path shutter time for object and camera motion (one shared draw).
shutter_times = shading.shutter_time


def _trace_pixels(scene, camera, config: RenderConfig, traversal: str,
                  pixel_index, sample_idx, seed: int, stats=None):
    """Per-path radiance ((R, 3)) for one wave of global pixel ids.
    ``sample_idx`` is one sample counter for the whole wave (an int or a
    0-d tensor) or an (R,) tensor, each ray at its own counter; both draw
    the same per-(pixel, sample) streams."""
    keys, origin, direction = shading.camera_sample(
        camera, config, seed, pixel_index, sample_idx
    )
    ld_nee = ld_scatter = None
    if config.sampler == "ld":
        # First-vertex stratified draws, computed once per sample.
        pick = rng.ld_scalar(seed, pixel_index, sample_idx, rng.STREAM_NEE)
        ld_nee = torch.stack(
            [pick, *rng.ld_pair(seed, pixel_index, sample_idx,
                                rng.STREAM_NEE)], dim=1)
        ld_scatter = torch.stack(
            rng.ld_pair(seed, pixel_index, sample_idx, rng.STREAM_SCATTER),
            dim=1)

    times = None
    if scene_mod.has_motion(scene):
        # The draw a moving camera took in camera_sample.
        times = shutter_times(config, seed, pixel_index, sample_idx, keys)
    n = pixel_index.shape[0]
    dev = pixel_index.device
    # (radiance, throughput, o, d, active, prev_pdf, prev_nee[, medium]
    # [, sss][, cone]): scenes with absorbing dielectrics carry each path's
    # interior sigma_a (zeros: vacuum), scenes with scattering dielectrics
    # its [sigma_s, g] row (zeros), scenes with mips its distance from the
    # camera (zeros), and the compaction permutes them with the rest. The
    # state is decoded by the scene's flags, never by its length.
    has_media = scene.mat_absorb is not None
    has_sss = scene.mat_interior is not None
    has_mips = scene_mod.uses_mips(scene)
    spread = shading.cone_spread_of(camera, config) if has_mips else None
    state = (
        torch.zeros((n, 3), dtype=torch.float32, device=dev),
        torch.ones((n, 3), dtype=torch.float32, device=dev),
        origin, direction,
        torch.ones(n, dtype=torch.bool, device=dev),
        torch.zeros(n, dtype=torch.float32, device=dev),
        torch.zeros(n, dtype=torch.bool, device=dev),
    )
    if has_media:
        state += (torch.zeros((n, 3), dtype=torch.float32, device=dev),)
    if has_sss:
        state += (torch.zeros((n, 2), dtype=torch.float32, device=dev),)
    if has_mips:
        state += (torch.zeros(n, dtype=torch.float32, device=dev),)
    per_path = [keys, ld_nee, ld_scatter, times]
    # The two-level walk counts only where stats are asked for.
    counts = (cluster_trace.walk_counts(dev)
              if stats is not None and scene.inst_tree is not None else None)

    def bounces(state, per_path, start, stop):
        ks, ldn, lds, tm = per_path
        for depth in range(start, stop):
            with metrics.span("engine.bounce"):
                out = shading.bounce_batch(
                    scene, state[2], state[3], ks, depth, state[0],
                    state[1], state[4], config.rr_start_depth,
                    config.background, traversal, nee=config.nee,
                    prev_pdf=state[5], prev_nee=state[6], ld_nee=ldn,
                    ld_scatter=lds, nee_candidates=config.nee_candidates,
                    return_shadow_count=True, time=tm,
                    medium=state[7] if has_media else None,
                    sss=state[7 + has_media] if has_sss else None,
                    cone=(state[7 + has_media + has_sss] if has_mips
                          else None),
                    cone_spread=spread, bin_rays=config.ray_sort,
                    counts=counts,
                )
            if stats is not None:
                stats["segments"] = stats.get("segments", 0) + state[4].sum()
                stats["shadow_segments"] = (stats.get("shadow_segments", 0)
                                            + out[-1])
            state = out[:-1]
        return state

    dnf_route = (scene_mod.uses_dnf(scene)
                 and traversal in ("cluster_cuda", "cluster_torch"))
    depths = [d for d in sorted(COMPACT_DEPTHS)
              if dnf_route and config.max_depth >= d + 2]
    start = 0
    # Per compaction: (inverse permutation, radiance at that depth, the
    # dead lanes' indices).
    undo = []
    for d in depths:
        state = bounces(state, per_path, start, d)
        with metrics.span("engine.compact"):
            perm, inv = binning.binning_perm(
                torch.where(state[4], 0, 1).to(torch.int32), 2
            )
            n_live = metrics.host_read("engine.compact", int,
                                       state[4].sum())
            undo.append((inv, state[0], perm[n_live:]))
            keep = perm[:n_live]
            state = tuple(a[keep] for a in state)
            per_path = [None if a is None else a[keep] for a in per_path]
        start = d
    radiance = bounces(state, per_path, start, config.max_depth)[0]
    if counts is not None:
        for name, n in zip(cluster_trace.WALK_COUNTS, counts):
            stats[name] = stats.get(name, 0) + n
    for inv, full_radiance, dead in reversed(undo):
        # Dead lanes keep the radiance they had at the compaction.
        radiance = torch.cat([radiance, full_radiance[dead]])[inv]
    return radiance
