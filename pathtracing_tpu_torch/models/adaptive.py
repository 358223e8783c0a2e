"""Variance-driven adaptive sampling (the JAX package's
``models/adaptive.py``): band-granular and tile-granular schedulers.

Band mode splits the image into row bands (``band_rows`` rows each); tile
mode into square tiles (8x8 by default). Each scheduling unit carries a
sample counter, and the state carries the radiance sum and a per-pixel
second moment (band mode: of the sample luminance; tile mode: per
channel). One greedy round scores every unit by the expected drop of the
image's squared error per sample, ``sum(s²) / (n (n + 1))`` (units with
fewer than 2 samples score ``3e38 - spp``: breadth first), picks the K
best, renders one dense wave over them (``megakernel.render_samples``
with ``rows=`` or ``pixels=``, each ray at its own unit's sample counter)
and adds the K blocks back (``index_add_`` over unique unit ids).

The RNG is counter based on global (pixel, sample) ids, so scheduling
changes where samples go, never what a sample computes: driving every
unit to equal spp gives ``progressive.render_step``'s image bit for bit.

The picks are a stable descending sort: among equal scores the lower
index comes first, as ``jax.lax.top_k`` orders them (``torch.topk``
promises no order). The round loops run on the host and never read the
card; only the ``target_rmse`` check (once per dispatch group) and the
auto-uniform Neyman bound read a value back.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pathtracing_tpu_torch.models import megakernel
from pathtracing_tpu_torch.utils import logging as ptlog
from pathtracing_tpu_torch.utils import metrics
from pathtracing_tpu_torch.utils.config import RenderConfig, resolve_device

_LUM = (0.2126, 0.7152, 0.0722)

# Pixel-samples per dispatch group of greedy rounds. The JAX package sized
# it for its device's dispatch limits; here it is a schedule parameter
# only: a render checks ``target_rmse`` (and reports progress) once per
# group, so it sets where a render stops and the rounds it returns.
MAX_DISPATCH_SAMPLES = 1 << 22

# The exploration score of a unit with fewer than 2 samples, less its spp.
_EXPLORE = 3.0e38


class AdaptiveState(NamedTuple):
    accum: torch.Tensor     # (H, W, 3) f32 — radiance sum
    m2: torch.Tensor        # (H, W) f32 — sum of per-sample luminance²
    band_spp: torch.Tensor  # (B,) i32 — samples accumulated per band
    seed: int               # base seed


def pick_band_rows(config: RenderConfig, band_rows: int = 0) -> int:
    """Default band height: the largest divisor of H that is at most 8
    rows; an explicit ``band_rows`` must divide H."""
    h = config.height
    if band_rows:
        if h % band_rows:
            raise ValueError(
                f"height {h} not divisible by band_rows {band_rows}")
        return band_rows
    return max(r for r in range(1, min(8, h) + 1) if h % r == 0)


def init_state(config: RenderConfig, band_rows: int,
               device=None) -> AdaptiveState:
    """Empty band state on ``device`` (the card unless the caller asks for
    another device)."""
    device = resolve_device(device)
    h, w = config.height, config.width
    if h % band_rows:
        raise ValueError(f"height {h} not divisible by band_rows {band_rows}")
    return AdaptiveState(
        accum=torch.zeros((h, w, 3), dtype=torch.float32, device=device),
        m2=torch.zeros((h, w), dtype=torch.float32, device=device),
        band_spp=torch.zeros(h // band_rows, dtype=torch.int32,
                             device=device),
        seed=int(config.seed),
    )


def _lum(rgb):
    return _LUM[0] * rgb[..., 0] + _LUM[1] * rgb[..., 1] + _LUM[2] * rgb[..., 2]


def _explore(spp, score):
    """Units with fewer than 2 samples rank first, fewest samples first."""
    return torch.where(spp < 2, _EXPLORE - spp.to(torch.float32), score)


def top_k(scores, k: int):
    """Indices of the ``k`` largest scores, lower index first among equal
    scores (``jax.lax.top_k``'s order)."""
    return torch.sort(scores, descending=True, stable=True).indices[:k]


def band_scores(state: AdaptiveState, config: RenderConfig,
                band_rows: int):
    """(B,) expected drop of the image's squared error per sample added to
    each band (module docstring)."""
    h, w = config.height, config.width
    n = torch.clamp(state.band_spp, min=1).to(torch.float32)     # (B,)
    n_px = torch.repeat_interleave(n, band_rows)[:, None]          # (H, 1)
    lum_sum = _lum(state.accum)                                    # (H, W)
    # Unbiased per-pixel sample variance s² = (m2 - n·mean²) / (n - 1).
    s2 = (torch.clamp(state.m2 - lum_sum * lum_sum / n_px, min=0.0)
          / torch.clamp(n_px - 1.0, min=1.0))
    band_s2 = s2.reshape(h // band_rows, band_rows * w).sum(dim=1)
    return _explore(state.band_spp, band_s2 / (n * (n + 1.0)))


def adaptive_step(state: AdaptiveState, scene, camera, config: RenderConfig,
                  band_rows: int, band_ids,
                  spp_per_round: int = 1) -> AdaptiveState:
    """Add ``spp_per_round`` samples to each band of ``band_ids`` ((K,)
    integer tensor, unique): one scattered-rows wave per sample over all K
    bands, each ray at its band's own sample counter, then an index add of
    whole band blocks. The state's tensors are updated in place (the
    returned state holds them)."""
    h, w = config.height, config.width
    n_bands = h // band_rows
    band_ids = band_ids.to(device=state.accum.device, dtype=torch.int64)
    k = band_ids.shape[0]
    rows = (band_ids[:, None] * band_rows
            + torch.arange(band_rows, device=band_ids.device)[None, :]
            ).reshape(-1)
    accum_b = state.accum.view(n_bands, band_rows, w, 3)
    m2_b = state.m2.view(n_bands, band_rows, w)
    start = state.band_spp[band_ids].to(torch.int64)
    for s in range(spp_per_round):
        blocks = megakernel.render_samples(
            scene, camera, config, sample_start=0, n_samples=1,
            seed=state.seed, rows=rows,
            rows_sample_start=torch.repeat_interleave(start + s, band_rows),
        ).reshape(k, band_rows, w, 3)
        accum_b.index_add_(0, band_ids, blocks)
        lum = _lum(blocks)
        m2_b.index_add_(0, band_ids, lum * lum)
    state.band_spp.index_add_(
        0, band_ids, torch.full((k,), spp_per_round, dtype=torch.int32,
                                device=band_ids.device))
    return state


def adaptive_rounds(state: AdaptiveState, scene, camera,
                    config: RenderConfig, band_rows: int, k: int,
                    n_rounds: int, spp_per_round: int = 1) -> AdaptiveState:
    """``n_rounds`` greedy rounds: each re-scores the bands on the device,
    picks the K best and renders them. Nothing is read back."""
    for _ in range(n_rounds):
        ids = top_k(band_scores(state, config, band_rows), k)
        state = adaptive_step(state, scene, camera, config, band_rows, ids,
                              spp_per_round)
    return state


def resolve(state: AdaptiveState, band_rows: int):
    """Per-pixel mean radiance with per-band normalization."""
    n = torch.clamp(state.band_spp, min=1).to(torch.float32)
    return state.accum / torch.repeat_interleave(n, band_rows)[:, None, None]


def render_adaptive(scene, camera, config: RenderConfig,
                    band_rows: int = 0, bands_per_round: int = 0,
                    warmup_spp: int = 2, progress=None,
                    budget_spp: Optional[int] = None,
                    spp_per_round: int = 1,
                    ) -> Tuple[AdaptiveState, int]:
    """Drive band-adaptive sampling to an average budget of
    ``config.samples_per_pixel`` spp (or ``budget_spp``): B · budget
    band-samples overall. ``warmup_spp`` rounds cover every band first
    (in chunks of K bands; the variance estimate needs 2 samples), then
    each round renders the ``bands_per_round`` (K, default B // 8) best
    bands, ``spp_per_round`` samples each. Returns (state, rounds)."""
    band_rows = pick_band_rows(config, band_rows)
    n_bands = config.height // band_rows
    k = min(bands_per_round or max(1, n_bands // 8), n_bands)
    state = init_state(config, band_rows, device=scene.tri_v0.device)

    target = budget_spp if budget_spp is not None else (
        config.samples_per_pixel)
    budget = n_bands * target            # band-samples to spend
    spent = rounds = 0

    all_bands = torch.arange(n_bands, device=scene.tri_v0.device)
    for _ in range(min(warmup_spp, target)):
        for i in range(0, n_bands, k):
            # A short tail chunk keeps its own size (padding it with
            # repeated ids would sample those bands twice).
            chunk = all_bands[i:i + k]
            state = adaptive_step(state, scene, camera, config, band_rows,
                                  chunk)
            spent += chunk.shape[0]
            rounds += 1
        if progress is not None:
            progress(state, spent, budget)

    spr = max(1, spp_per_round)
    samples_per_round = k * band_rows * config.width * spr
    rounds_per_group = max(1, MAX_DISPATCH_SAMPLES // samples_per_round)
    while spent + k * spr <= budget:
        n_r = min(rounds_per_group, (budget - spent) // (k * spr))
        state = adaptive_rounds(state, scene, camera, config, band_rows, k,
                                n_r, spr)
        spent += n_r * k * spr
        rounds += n_r
        if progress is not None:
            progress(state, spent, budget)
    # A budget tail finer than k·spr band-samples finishes in 1-spp
    # rounds, so the band-samples spent equal the budget exactly.
    while spent + k <= budget:
        n_r = (budget - spent) // k
        state = adaptive_rounds(state, scene, camera, config, band_rows, k,
                                n_r, 1)
        spent += n_r * k
        rounds += n_r
        if progress is not None:
            progress(state, spent, budget)
    return state, rounds


# --- Tile-granular scheduling -------------------------------------------
#
# Square tiles follow 2D-compact noise that full-row bands cannot. The
# state lives tile-major ((T, t, t[, 3])), so the index adds move whole
# tiles; ``resolve_tiles`` untiles to image layout once at the end.


class TileState(NamedTuple):
    accum: torch.Tensor     # (T, t, t, 3) f32 — tile-major radiance sum
    m2: torch.Tensor        # (T, t, t, 3) f32 — per-sample radiance² sum
    tile_spp: torch.Tensor  # (T,) i32 — samples accumulated per tile
    seed: int               # base seed


def pick_tile(config: RenderConfig, tile: int = 8) -> int:
    if config.height % tile or config.width % tile:
        raise ValueError(
            f"image {config.width}x{config.height} not divisible by "
            f"tile {tile}")
    return tile


def init_tile_state(config: RenderConfig, tile: int,
                    device=None) -> TileState:
    """Empty tile state on ``device`` (the card unless the caller asks for
    another device)."""
    device = resolve_device(device)
    n_tiles = (config.height // tile) * (config.width // tile)
    return TileState(
        accum=torch.zeros((n_tiles, tile, tile, 3), dtype=torch.float32,
                          device=device),
        m2=torch.zeros((n_tiles, tile, tile, 3), dtype=torch.float32,
                       device=device),
        tile_spp=torch.zeros(n_tiles, dtype=torch.int32, device=device),
        seed=int(config.seed),
    )


def _tile_var1(state: TileState):
    """Unbiased per-pixel, per-channel sample variance ((T, t, t, 3)) and
    each tile's spp as f32 ((T,)): the RGB squared error the quality
    metric measures."""
    n = torch.clamp(state.tile_spp, min=1).to(torch.float32)
    n4 = n[:, None, None, None]
    mean = state.accum / n4
    var1 = torch.clamp(state.m2 / n4 - mean * mean, min=0.0) * (
        n / torch.clamp(n - 1.0, min=1.0))[:, None, None, None]
    return var1, n


def tile_scores(state: TileState, config: RenderConfig, tile: int):
    """(T,) greedy tile scores: sum over pixels and channels of
    s² / (n (n + 1)); tiles with fewer than 2 samples rank first."""
    var1, n = _tile_var1(state)
    return _explore(state.tile_spp,
                    var1.sum(dim=(1, 2, 3)) / (n * (n + 1.0)))


def _tile_pixel_ids(tile_ids, config: RenderConfig, tile: int):
    """Global pixel ids ((K · tile · tile,)) of the given tiles, tile by
    tile, each tile row-major."""
    w = config.width
    ntx = w // tile
    ar = torch.arange(tile, device=tile_ids.device)
    py = (tile_ids // ntx)[:, None, None] * tile + ar[None, :, None]
    px = (tile_ids % ntx)[:, None, None] * tile + ar[None, None, :]
    return (py * w + px).reshape(-1)


def tile_step(state: TileState, scene, camera, config: RenderConfig,
              tile: int, tile_ids, spp_per_round: int = 1,
              tile_offset: int = 0) -> TileState:
    """Add ``spp_per_round`` samples to each tile of ``tile_ids`` ((K,),
    unique): one scattered-pixels wave per sample, packed tile-major, and
    an index add of whole tiles. Updates the state in place.

    ``tile_offset``: the state holds the image's tiles from this one on
    (a shard's stripe, ``parallel/adaptive.py``); the waves trace the
    global tiles ``tile_ids + tile_offset``, so every sample keeps its
    global (pixel, sample) id."""
    tile_ids = tile_ids.to(device=state.accum.device, dtype=torch.int64)
    k = tile_ids.shape[0]
    pix = _tile_pixel_ids(tile_ids + tile_offset, config, tile)
    start = state.tile_spp[tile_ids].to(torch.int64)
    for s in range(spp_per_round):
        blocks = megakernel.render_samples(
            scene, camera, config, sample_start=0, n_samples=1,
            seed=state.seed, pixels=pix,
            pixels_sample_start=torch.repeat_interleave(start + s,
                                                        tile * tile),
        ).reshape(k, tile, tile, 3)
        state.accum.index_add_(0, tile_ids, blocks)
        state.m2.index_add_(0, tile_ids, blocks * blocks)
    state.tile_spp.index_add_(
        0, tile_ids, torch.full((k,), spp_per_round, dtype=torch.int32,
                                device=tile_ids.device))
    return state


def tile_rounds(state: TileState, scene, camera, config: RenderConfig,
                tile: int, k: int, n_rounds: int,
                spp_per_round: int = 1) -> TileState:
    """``n_rounds`` greedy tile rounds, as ``adaptive_rounds``; each is
    one ``engine.step`` span (``utils.metrics``)."""
    for _ in range(n_rounds):
        with metrics.step():
            ids = top_k(tile_scores(state, config, tile), k)
            state = tile_step(state, scene, camera, config, tile, ids,
                              spp_per_round)
    return state


def tile_neyman_gain(state: TileState, config: RenderConfig, tile: int):
    """Upper bound (0-d tensor) on the squared-error gain any tile-level
    allocation can reach over uniform sampling, from the current variance
    estimate: Neyman allocation gives ``mean(σ²) / mean(σ)²`` (>= 1, 1 when
    the variance is the same in every tile), σ² a tile's summed per-pixel,
    per-channel sample variance."""
    var1, _ = _tile_var1(state)
    sig2 = var1.sum(dim=(1, 2, 3))
    return sig2.mean() / torch.clamp(torch.sqrt(sig2).mean() ** 2,
                                     min=1e-30)


def predicted_rmse(state: TileState, config: RenderConfig, tile: int):
    """Predicted RGB RMSE (0-d tensor) of the current mean image against
    the converged one: sqrt(mean(Var / n)) over every pixel and channel,
    an i.i.d. standard-error estimate (the LD sampler's true error sits at
    or below it, so a ``target_rmse`` stop is conservative)."""
    var1, n = _tile_var1(state)
    return torch.sqrt((var1 / n[:, None, None, None]).mean())


def uniform_tile_rounds(state: TileState, scene, camera,
                        config: RenderConfig, tile: int,
                        n_samples: int) -> TileState:
    """``n_samples`` full-image samples added to a tile-major state through
    block mode: the sample ids the greedy scheduler would issue if it
    picked every tile (tile 0's counter stands for all of them), so the
    state stays interchangeable with the uniform engines'. Each sample
    is one ``engine.step`` span."""
    h, w = config.height, config.width
    nty, ntx = h // tile, w // tile
    start = state.tile_spp[0].to(torch.int64)
    for s in range(n_samples):
        with metrics.step():
            img = megakernel.render_samples(
                scene, camera, config, sample_start=start + s, n_samples=1,
                seed=state.seed)
            blocks = img.reshape(nty, tile, ntx, tile, 3).permute(
                0, 2, 1, 3, 4).reshape(-1, tile, tile, 3)
            state.accum.add_(blocks)
            state.m2.add_(blocks * blocks)
    state.tile_spp.add_(n_samples)
    return state


def resolve_tiles(state: TileState, config: RenderConfig, tile: int):
    """Per-pixel mean radiance, untiled to (H, W, 3) image layout."""
    h, w = config.height, config.width
    nty, ntx = h // tile, w // tile
    n = torch.clamp(state.tile_spp, min=1).to(torch.float32)
    mean = state.accum / n[:, None, None, None]
    return mean.reshape(nty, ntx, tile, tile, 3).permute(
        0, 2, 1, 3, 4).reshape(h, w, 3)


def render_adaptive_tiles(scene, camera, config: RenderConfig,
                          tile: int = 8, tiles_per_round: int = 0,
                          warmup_spp: int = 2, progress=None,
                          budget_spp: Optional[int] = None,
                          spp_per_round: int = 2,
                          auto_uniform: float = 0.0,
                          target_rmse: float = 0.0,
                          ) -> Tuple[TileState, int]:
    """Tile-granular ``render_adaptive``: 8x8 tiles, K = T // 8 a round,
    2 spp per picked tile a round by default.

    ``auto_uniform`` > 0: after the warmup the Neyman bound
    (``tile_neyman_gain``) is read once; below this threshold the rest of
    the budget renders as full-image samples (``uniform_tile_rounds``,
    the same sample ids). ``target_rmse`` > 0 makes the budget a cap:
    after the warmup and after every dispatch group ``predicted_rmse`` is
    read, and rendering stops once it reaches the target; it needs every
    tile at 2 samples or more, so a warmup below 2 disables it with a
    warning. Returns (state, rounds)."""
    tile = pick_tile(config, tile)
    n_tiles = (config.height // tile) * (config.width // tile)
    k = min(tiles_per_round or max(1, n_tiles // 8), n_tiles)
    device = scene.tri_v0.device
    state = init_tile_state(config, tile, device=device)

    target = budget_spp if budget_spp is not None else (
        config.samples_per_pixel)
    warm = min(warmup_spp, target)
    if target_rmse > 0.0 and warm < 2:
        # With n <= 1 the variance estimate is zero, so every check would
        # stop at once with most tiles unsampled. The warning reports the
        # value the guard tests.
        ptlog.log_warning(
            "target_rmse needs a warmup of >= 2 spp (got min(warmup_spp, "
            "budget) = %d) — stopping rule disabled, rendering the full "
            "budget", warm,
        )
        target_rmse = 0.0

    def hit_target(st: TileState) -> bool:
        return (target_rmse > 0.0
                and metrics.host_read("tiles.rmse", float, predicted_rmse(
                    st, config, tile)) <= target_rmse)

    budget = n_tiles * target
    spent = rounds = 0

    all_tiles = torch.arange(n_tiles, device=device)
    for _ in range(warm):
        for i in range(0, n_tiles, k):
            chunk = all_tiles[i:i + k]
            with metrics.step():
                state = tile_step(state, scene, camera, config, tile, chunk)
            spent += chunk.shape[0]
            rounds += 1
        if progress is not None:
            progress(state, spent, budget)
    if warm >= 2 and hit_target(state):
        return state, rounds

    if auto_uniform > 0.0 and warmup_spp >= 2 and spent < budget:
        gain = metrics.host_read("tiles.neyman", float,
                                 tile_neyman_gain(state, config, tile))
        ptlog.log_information(
            "adaptive: Neyman gain bound %.2f vs auto-uniform threshold "
            "%.2f -> %s scheduling", gain, auto_uniform,
            "uniform" if gain < auto_uniform else "greedy",
        )
        if gain < auto_uniform:
            # Too uniform for any allocation to beat the scheduler's
            # overhead: the rest as full-image samples, same sample ids.
            per_sample = config.height * config.width
            max_chunk = max(1, MAX_DISPATCH_SAMPLES // per_sample)
            remaining = (budget - spent) // n_tiles      # whole spp only
            if target_rmse > 0.0:
                max_chunk = min(max_chunk, 4)
            done = 0
            while done < remaining:
                n_s = min(max_chunk, remaining - done)
                state = uniform_tile_rounds(state, scene, camera, config,
                                            tile, n_s)
                done += n_s
                spent += n_s * n_tiles
                rounds += n_s
                if progress is not None:
                    progress(state, spent, budget)
                if hit_target(state):
                    break
            return state, rounds
    spr = max(1, spp_per_round)
    samples_per_round = k * tile * tile * spr
    rounds_per_group = max(1, MAX_DISPATCH_SAMPLES // samples_per_round)
    if target_rmse > 0.0:
        # Check the stopping rule about every 2 average spp.
        rounds_per_group = min(rounds_per_group,
                               max(1, (n_tiles * 2) // (k * spr)))
    while spent + k * spr <= budget:
        n_r = min(rounds_per_group, (budget - spent) // (k * spr))
        state = tile_rounds(state, scene, camera, config, tile, k, n_r, spr)
        spent += n_r * k * spr
        rounds += n_r
        if progress is not None:
            progress(state, spent, budget)
        if hit_target(state):
            return state, rounds
    while spent + k <= budget:
        n_r = (budget - spent) // k
        state = tile_rounds(state, scene, camera, config, tile, k, n_r, 1)
        spent += n_r * k
        rounds += n_r
        if progress is not None:
            progress(state, spent, budget)
        if hit_target(state):
            return state, rounds
    return state, rounds
