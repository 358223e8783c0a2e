"""Tiled rendering with per-band completion tracking and fault injection
(the JAX package's ``utils/tiles.py``).

The image renders in independent row bands, each with its own sample
counter saved beside the accumulator, so a resumed render re-renders only
the bands that are behind, and a fault can be injected (``inject_fault``
drops a band's radiance and counter mid-run) to exercise that recovery.
Bands are the megakernel's row blocks (``row_start`` / ``block_rows``)
over global pixel and sample ids, so a recovered render equals an
uninterrupted one bit for bit.

The accumulator lives on the device; the per-band counters stay on the
host (numpy), as in the JAX package, since the scheduler reads them every
band.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from pathtracing_tpu_torch.models import megakernel
from pathtracing_tpu_torch.utils.config import RenderConfig, resolve_device


class TiledState(NamedTuple):
    accum: torch.Tensor    # (H, W, 3) f32 radiance sum, on the device
    band_spp: np.ndarray   # (B,) i32 samples completed per band (host)
    seed: int              # base seed


def init_tiled(config: RenderConfig, n_bands: int,
               device=None) -> TiledState:
    """Empty state on ``device`` (the card unless the caller asks for
    another device)."""
    if config.height % n_bands:
        raise ValueError(
            f"height {config.height} not divisible into {n_bands} bands"
        )
    return TiledState(
        accum=torch.zeros((config.height, config.width, 3),
                          dtype=torch.float32, device=resolve_device(device)),
        band_spp=np.zeros(n_bands, np.int32),
        seed=int(config.seed),
    )


def _fingerprint(config: RenderConfig, n_bands: int) -> str:
    payload = json.dumps(
        (dataclasses.asdict(config), n_bands), sort_keys=True
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def save(path: str, state: TiledState, config: RenderConfig) -> None:
    """Write ``state`` atomically (the JAX package's file layout)."""
    tmp = path + ".tmp.npz"
    np.savez(
        tmp,
        accum=state.accum.detach().cpu().numpy(),
        band_spp=state.band_spp,
        seed=np.uint32(state.seed),
        fingerprint=np.frombuffer(
            _fingerprint(config, len(state.band_spp)).encode(),
            dtype=np.uint8,
        ),
    )
    os.replace(tmp, path)


def load(path: str, config: RenderConfig, n_bands: int,
         device=None) -> TiledState:
    device = resolve_device(device)
    with np.load(path) as data:
        stored = bytes(data["fingerprint"]).decode()
        want = _fingerprint(config, n_bands)
        if stored != want:
            raise ValueError(
                f"tiled checkpoint {path} was written with a different "
                f"config/band layout (fingerprint {stored} != {want}); "
                "refusing to resume"
            )
        return TiledState(
            accum=torch.as_tensor(np.array(data["accum"], np.float32),
                                  device=device),
            band_spp=np.array(data["band_spp"], np.int32),
            seed=int(data["seed"]),
        )


def _band_rows(state: TiledState):
    return state.accum.shape[0] // len(state.band_spp)


def render_band(scene, camera, config: RenderConfig, state: TiledState,
                band: int, n_samples: int) -> TiledState:
    """Advance one band by ``n_samples`` spp. The accumulator is updated
    in place (the returned state holds the same tensor)."""
    rows = _band_rows(state)
    block = megakernel.render_samples(
        scene, camera, config, sample_start=int(state.band_spp[band]),
        n_samples=n_samples, seed=state.seed, row_start=band * rows,
        block_rows=rows,
    )
    state.accum[band * rows:(band + 1) * rows] += block
    band_spp = state.band_spp.copy()
    band_spp[band] += n_samples
    return TiledState(accum=state.accum, band_spp=band_spp, seed=state.seed)


def inject_fault(state: TiledState, band: int) -> TiledState:
    """Drop one band's accumulated radiance and its counter: a lost or
    corrupted tile (the CLI's ``--inject-fault``)."""
    rows = _band_rows(state)
    state.accum[band * rows:(band + 1) * rows] = 0.0
    band_spp = state.band_spp.copy()
    band_spp[band] = 0
    return TiledState(accum=state.accum, band_spp=band_spp, seed=state.seed)


def resolve_tiled(state: TiledState) -> torch.Tensor:
    """Mean-radiance image (H, W, 3) with per-band normalization (bands may
    hold different sample counts under adaptive scheduling)."""
    n = torch.as_tensor(np.maximum(state.band_spp, 1).astype(np.float32),
                        device=state.accum.device)
    return state.accum / torch.repeat_interleave(
        n, _band_rows(state))[:, None, None]


def render_tiled_adaptive(scene, camera, config: RenderConfig,
                          n_bands: int, progress=None) -> TiledState:
    """Adaptive sampling over bands: ``n_bands * samples_per_pixel``
    band-samples, spent ``samples_per_step`` at a time on the band whose
    mean still moves the most between its visits (the relative luminance
    change, damped by 1/sqrt(spp)); unexplored bands first, and every band
    gets two visits so the proxy exists. Resolve with ``resolve_tiled``."""
    state = init_tiled(config, n_bands, device=scene.tri_v0.device)
    step = config.samples_per_step
    budget = n_bands * config.samples_per_pixel
    rows = config.height // n_bands

    prev_mean = np.zeros(n_bands)
    score = np.full(n_bands, np.inf)
    spent = 0
    while spent + step <= budget:
        band = int(np.argmax(score))
        before = prev_mean[band]
        state = render_band(scene, camera, config, state, band, step)
        spent += step
        n = int(state.band_spp[band])
        mean_now = float(state.accum[band * rows:(band + 1) * rows].mean()
                         ) / max(n, 1)
        if n >= 2 * step:
            rel_delta = abs(mean_now - before) / max(abs(mean_now), 1e-6)
            score[band] = rel_delta / np.sqrt(n)
        prev_mean[band] = mean_now
        if progress is not None:
            progress(band, n)
    return state


def render_tiled(scene, camera, config: RenderConfig, n_bands: int,
                 state: Optional[TiledState] = None,
                 checkpoint_path: Optional[str] = None,
                 inject_fault_band: Optional[int] = None,
                 progress=None) -> TiledState:
    """Drive every band to ``config.samples_per_pixel``, resumably, in
    rounds of ``samples_per_step``; lagging bands (after a resume or an
    injected fault) catch up first. ``checkpoint_path`` is written after
    every band; ``inject_fault_band`` is dropped once, when every band
    has reached half the target; ``progress(band, band_spp)`` is called
    after every band."""
    if state is None:
        state = init_tiled(config, n_bands, device=scene.tri_v0.device)
    target = config.samples_per_pixel
    step = config.samples_per_step

    fault_done = inject_fault_band is None
    while int(state.band_spp.min()) < target:
        band = int(np.argmin(state.band_spp))
        n = min(step, target - int(state.band_spp[band]))
        state = render_band(scene, camera, config, state, band, n)
        if progress is not None:
            progress(band, int(state.band_spp[band]))
        if checkpoint_path:
            save(checkpoint_path, state, config)
        if not fault_done and state.band_spp.min() >= target // 2:
            state = inject_fault(state, inject_fault_band)
            fault_done = True
    return state
