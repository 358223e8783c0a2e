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

A wave that compacts runs as two segments around the compaction's one
host read (``segment_a``, ``segment_b``). On the card, a block wave
through the CUDA kernels replays them as CUDA graphs captured once
(``models.graphs``, ``_trace_wave``); every other wave issues them op
by op (``_trace_pixels``). Both give the same bits.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional

import torch

from pathtracing_tpu_torch.models import graphs
from pathtracing_tpu_torch.models import scene as scene_mod
from pathtracing_tpu_torch.models import shading
from pathtracing_tpu_torch.ops import binning, cluster_trace, rng
from pathtracing_tpu_torch.utils import metrics
from pathtracing_tpu_torch.utils.config import RenderConfig

# Ceiling on rays per bounce wave. The JAX package's 1 << 18 exists for a
# TPU tile-padding reason; on an 80 GB card a whole 1920x1080 frame
# (2,073,600 rays) fits one wave. Chunking never changes a pixel's result.
MAX_WAVE_RAYS = 1 << 21

# Depths at which surviving paths may be compacted live-first (a stable
# 2-bin permutation of the per-path state); a wave compacts once, at the
# first that applies (``compact_depth``). The bounces after it trace only
# the live lanes — dead lanes' radiance never changes again — scattered
# back to pixel order at the end: a pure reordering, so per-path results
# are unchanged.
COMPACT_DEPTHS = (3,)

# Lanes to which a replayed wave rounds its live count after the
# compaction: segment B runs at the live count rounded up to a multiple of
# it, padded with the next dead lanes of the permutation, so one or two
# graphs serve a scene's frames (``segment_b``, ``models.graphs``).
GRAPH_BUCKET = 1 << 14

# The span of one run of bounces between compactions issued op by op
# (``utils.metrics``); a replayed one is an ``engine.replay`` span.
SEGMENT_SPAN = "engine.segment"


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
    # The graphs, where one sample's waves all fit the cache.
    replayed = (n_chunks <= GRAPH_WAVES
                and _replays(scene, config, traversal))
    accum = torch.zeros((block_rows, w, 3), dtype=torch.float32,
                        device=device)
    for sample_ofs in range(n_samples):
        sample_idx = sample_start + sample_ofs * sample_stride
        for ci in range(n_chunks):
            r0 = ci * chunk_rows
            radiance = None
            if replayed:
                radiance = _trace_wave(scene, camera, config, traversal,
                                       row_start + r0, chunk_rows,
                                       sample_idx, seed, stats)
            if radiance is None:
                pixel_index = _block_pixels(row_start + r0, chunk_rows, w,
                                            device)
                radiance = _trace_pixels(scene, camera, config, traversal,
                                         pixel_index, sample_idx, seed,
                                         stats)
            radiance = radiance.reshape(chunk_rows, w, 3)
            # Padded rows of a ceil-split last chunk are dropped here.
            n = min(chunk_rows, block_rows - r0)
            accum[r0:r0 + n] += radiance[:n]
    return accum


def _block_pixels(row0: int, rows: int, w: int, device):
    """Global pixel ids of image rows [row0, row0 + rows), row-major."""
    ys = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.int64, device=device)[None, :]
    return ((ys + row0) * w + xs).reshape(-1)


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
            n = min(chunk, n_units - u0)
            accum[u0:u0 + n] += radiance[:n]
    return accum[:, 0] if width == 1 else accum


# Per-path shutter time for object and camera motion (one shared draw).
shutter_times = shading.shutter_time


def _first_vertex(scene, camera, config: RenderConfig, pixel_index,
                  sample_idx, seed: int):
    """A wave's paths before their first bounce: (state, per-path draws,
    the cone spread). ``sample_idx`` is one sample counter for the whole
    wave (an int or a tensor of one element) or an (R,) tensor, each ray at
    its own counter; both draw the same per-(pixel, sample) streams."""
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
    if scene.mat_absorb is not None:
        state += (torch.zeros((n, 3), dtype=torch.float32, device=dev),)
    if scene.mat_interior is not None:
        state += (torch.zeros((n, 2), dtype=torch.float32, device=dev),)
    if has_mips:
        state += (torch.zeros(n, dtype=torch.float32, device=dev),)
    return state, [keys, ld_nee, ld_scatter, times], spread


def _walk_counts(scene, stats, device):
    """The two-level walk's counter, where ``stats`` are taken."""
    if stats is None or scene.inst_tree is None:
        return None
    return cluster_trace.walk_counts(device)


def _add_walk_counts(stats, counts):
    if counts is not None:
        for name, n in zip(cluster_trace.WALK_COUNTS, counts):
            stats[name] = stats.get(name, 0) + n


def _add_tallies(stats, *tallies):
    for tally in tallies:
        for name, n in (tally or {}).items():
            stats[name] = stats.get(name, 0) + n


def _bouncer(scene, config: RenderConfig, traversal: str, spread, counts):
    """``bounces(state, per_path, start, stop, stats)``: the bounces
    [start, stop) of a wave, each an ``engine.bounce`` span; ``stats``
    (a dict, or None) accumulates ``segments`` and ``shadow_segments``."""
    has_media = scene.mat_absorb is not None
    has_sss = scene.mat_interior is not None
    has_mips = scene_mod.uses_mips(scene)

    def bounces(state, per_path, start, stop, stats):
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

    return bounces


def _clamped(config: RenderConfig, radiance):
    if config.clamp > 0.0:
        return torch.clamp(radiance, max=config.clamp)
    return radiance


def compact_depth(scene, config: RenderConfig, traversal: str):
    """The depth at which this wave compacts, or None: the first of
    ``COMPACT_DEPTHS`` on the cluster sweeps and the two-level walk with
    two or more bounces left after it."""
    dnf_route = (scene_mod.uses_dnf(scene)
                 and traversal in ("cluster_cuda", "cluster_torch"))
    return next((d for d in sorted(COMPACT_DEPTHS)
                 if dnf_route and config.max_depth >= d + 2), None)


def _trace_pixels(scene, camera, config: RenderConfig, traversal: str,
                  pixel_index, sample_idx, seed: int, stats=None):
    """Per-path clamped radiance ((R, 3)) for one wave of global pixel
    ids, op by op: ``segment_a``, the compaction's one host read and
    ``segment_b`` at the live count, or, in a wave that does not compact,
    every bounce; each segment an ``engine.segment`` span. ``sample_idx``
    as in ``_first_vertex``."""
    take = stats is not None
    if compact_depth(scene, config, traversal) is None:
        with metrics.span(SEGMENT_SPAN):
            state, per_path, spread = _first_vertex(
                scene, camera, config, pixel_index, sample_idx, seed)
            counts = _walk_counts(scene, stats, pixel_index.device)
            radiance = _bouncer(scene, config, traversal, spread, counts)(
                state, per_path, 0, config.max_depth, stats)[0]
            _add_walk_counts(stats, counts)
        return _clamped(config, radiance)
    with metrics.span(SEGMENT_SPAN):
        a = segment_a(scene, camera, config, traversal, pixel_index,
                      sample_idx, seed, take)
    with metrics.span("engine.compact"):
        n_live = metrics.host_read("engine.compact", int, a.n_live)
    with metrics.span(SEGMENT_SPAN):
        radiance, tally_b = segment_b(scene, config, traversal, a, n_live,
                                      take)
    if take:
        _add_tallies(stats, a.tally, tally_b)
    return radiance


# --- The two segments of a compacting wave ----------------------------------


class Compacted(NamedTuple):
    """Segment A's result: the paths at the compaction depth in pixel
    order, the compaction's live-first permutation and live count (a
    0-d device tensor), the cone spread, and the segment's tally (None
    without stats)."""
    state: tuple
    per_path: list
    perm: torch.Tensor
    n_live: torch.Tensor
    spread: Optional[float]
    tally: Optional[dict]


def bucket(n_live: int, n: int) -> int:
    """Lanes segment B runs at in a replayed wave: ``n_live`` rounded up
    to ``GRAPH_BUCKET``, at most the wave's ``n``."""
    return min(n, -(-n_live // GRAPH_BUCKET) * GRAPH_BUCKET)


def segment_a(scene, camera, config: RenderConfig, traversal: str,
              pixel_index, sample_idx, seed: int,
              take_stats: bool) -> Compacted:
    """A wave up to its compaction, with no host read: the first vertex,
    the bounces before ``compact_depth``, the live-first permutation
    (``binning.binning_perm``) and the live count on the device.
    ``take_stats``: the tally holds ``segments``, ``shadow_segments``
    and, in the two-level walk, ``WALK_COUNTS``."""
    depth = compact_depth(scene, config, traversal)
    state, per_path, spread = _first_vertex(scene, camera, config,
                                            pixel_index, sample_idx, seed)
    tally = {} if take_stats else None
    counts = _walk_counts(scene, tally, pixel_index.device)
    state = _bouncer(scene, config, traversal, spread, counts)(
        state, per_path, 0, depth, tally)
    perm, _ = binning.binning_perm(
        torch.where(state[4], 0, 1).to(torch.int32), 2)
    _add_walk_counts(tally, counts)
    return Compacted(state, per_path, perm, state[4].sum(), spread, tally)


def segment_b(scene, config: RenderConfig, traversal: str, a: Compacted,
              lanes: int, take_stats: bool):
    """The rest of a wave from ``segment_a``'s ``a``: the bounces after
    the compaction on the first ``lanes`` lanes of its permutation (the
    live lanes, then the next dead ones: a dead lane's radiance never
    changes again), each lane's radiance scattered back over the radiance
    at the compaction, then the clamp. ``lanes`` is at least the live
    count. Returns ((R, 3) radiance in pixel order, the tally as
    ``segment_a``'s): the same bits for every such ``lanes``."""
    keep = a.perm[:lanes]
    state = tuple(x[keep] for x in a.state)
    per_path = [None if x is None else x[keep] for x in a.per_path]
    tally = {} if take_stats else None
    counts = _walk_counts(scene, tally, keep.device)
    radiance = _bouncer(scene, config, traversal, a.spread, counts)(
        state, per_path, compact_depth(scene, config, traversal),
        config.max_depth, tally)[0]
    _add_walk_counts(tally, counts)
    return _clamped(config, a.state[0].index_copy(0, keep, radiance)), tally


# --- Replayed block waves (``models.graphs``) -------------------------------

# Waves kept (each a key's static inputs and graphs, least recently used
# dropped), and segment-B graphs (buckets) each keeps, oldest dropped.
GRAPH_WAVES = 4
GRAPH_BUCKETS = 2

# Sightings that pay back a capture: at 1920x1080 on an H100 a capture
# costs the host what replays save over 8 to 24 waves. Where keys are
# seen fewer times, a new key waits for this many (``_capture_at``).
PAYBACK = 16

# The config fields a wave's bounces read (its graphs' key).
_BOUNCE_FIELDS = ("width", "height", "max_depth", "rr_start_depth",
                  "background", "nee", "nee_candidates", "sampler", "clamp",
                  "ray_sort")


def _replays(scene, config: RenderConfig, traversal: str) -> bool:
    """Whether this render's block waves take the graphs: tensors on the
    card, the CUDA kernels, and a compaction (the one host read)."""
    return (scene.tri_v0.device.type == "cuda"
            and traversal == "cluster_cuda"
            and compact_depth(scene, config, traversal) is not None)


class _Wave:
    """A key's static inputs and graphs: the pixel ids, the sample index
    (a 0-d device tensor, written before each replay: the RNG kernels read
    it on the card), segment A's graph (None until captured), segment B's
    by bucket, whether the key runs op by op, how often it was seen, and
    the sighting after which it is captured. It holds the scene and
    camera, whose tables and values the graphs read."""

    def __init__(self, scene, camera, seed, pixel_index, capture_at):
        self.scene, self.camera, self.seed = scene, camera, seed
        self.pixel = pixel_index
        self.sample = torch.zeros((), dtype=torch.int64,
                                  device=pixel_index.device)
        self.a, self.b = None, {}
        self.eager = False
        self.seen = 0
        self.capture_at = capture_at


_WAVES = collections.OrderedDict()


def clear_graphs() -> None:
    """Drop every kept wave and graph, with the scenes and cameras they
    hold."""
    _WAVES.clear()


def _capture_at(camera, seed) -> int:
    """The sighting after which a new key is captured: its first, where
    the key used before it shares its camera and seed (another wave of the
    same frames, or the same frames taking stats) or was seen ``PAYBACK``
    times; else its ``PAYBACK``-th. A frame sequence that brings a new
    camera or seed every few samples (an orbit) pays for one capture, not
    one a frame."""
    last = next(reversed(_WAVES.values()), None)
    if (last is None or last.seen >= PAYBACK
            or (last.camera is camera and last.seed == seed)):
        return 1
    return PAYBACK


def _trace_wave(scene, camera, config: RenderConfig, traversal: str,
                row0: int, rows: int, sample_idx, seed: int, stats):
    """The clamped radiance ((rows·W, 3)) of the block wave of image rows
    [row0, row0 + rows) through its graphs, or None where its key runs op
    by op. Segment A replays, the host reads the live count, segment B
    replays at its bucket. Until its key is captured (``_capture_at``), a
    wave runs op by op (``SEGMENT_SPAN``), and so does one at a new
    bucket; each is captured after it has run. In traced frames each
    segment's tally is added into ``stats`` on the card. A replayed
    result is a graph's output: read it before the next wave."""
    dev = scene.tri_v0.device
    take = stats is not None
    key = (dev, row0, rows, id(scene), id(camera),
           tuple(getattr(config, f) for f in _BOUNCE_FIELDS), traversal,
           int(seed), take)
    wave = _WAVES.get(key)
    if wave is None:
        wave = _Wave(scene, camera, int(seed),
                     _block_pixels(row0, rows, config.width, dev),
                     _capture_at(camera, int(seed)))
        _WAVES[key] = wave
        if len(_WAVES) > GRAPH_WAVES:
            _WAVES.popitem(last=False)
    _WAVES.move_to_end(key)
    if wave.eager:
        return None
    wave.seen += 1
    if torch.is_tensor(sample_idx):
        wave.sample.copy_(sample_idx.reshape(()))
    else:
        wave.sample.fill_(sample_idx)

    def run_a():
        return segment_a(scene, camera, config, traversal, wave.pixel,
                         wave.sample, seed, take)

    if wave.a is None:
        with metrics.span(SEGMENT_SPAN):
            a = run_a()
    else:
        a = wave.a.replay()
    with metrics.span("engine.compact"):
        n_live = metrics.host_read("engine.compact", int, a.n_live)
    lanes = bucket(n_live, wave.pixel.shape[0])
    b = wave.b.get(lanes)
    if b is None:
        with metrics.span(SEGMENT_SPAN):
            radiance, tally_b = segment_b(scene, config, traversal, a,
                                          lanes, take)
    else:
        radiance, tally_b = b.replay()
    if take:
        _add_tallies(stats, a.tally, tally_b)
    if wave.seen < wave.capture_at:
        return radiance
    # Capture what ran op by op, now that it has run at this key.
    if wave.a is None:
        del a
        wave.a = graphs.capture(run_a, dev)
    if wave.a is not None and b is None:
        b = graphs.capture(
            lambda: segment_b(scene, config, traversal, wave.a.out, lanes,
                              take), dev, share=wave.a)
        if b is not None:
            if len(wave.b) >= GRAPH_BUCKETS:
                del wave.b[next(iter(wave.b))]
            wave.b[lanes] = b
    if wave.a is None or b is None:
        wave.eager, wave.a, wave.b = True, None, {}
    return radiance
