"""Progressive render engine (the JAX package's ``models/progressive.py``).

State is (accum, spp, seed): the radiance sum, the samples accumulated
so far and the base seed. The RNG is counter based, so a step continues
the exact sample sequence of the steps before it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pathtracing_tpu_torch.models import megakernel
from pathtracing_tpu_torch.utils import metrics
from pathtracing_tpu_torch.utils.config import RenderConfig, resolve_device


class RenderState(NamedTuple):
    accum: torch.Tensor   # (H, W, 3) f32 — radiance sum (not mean)
    spp: int              # samples accumulated so far
    seed: int             # base seed (constant across steps)


def init_state(config: RenderConfig, device=None) -> RenderState:
    """Empty state on ``device`` (the card unless the caller asks for
    another device)."""
    device = resolve_device(device)
    return RenderState(
        accum=torch.zeros((config.height, config.width, 3),
                          dtype=torch.float32, device=device),
        spp=0,
        seed=int(config.seed),
    )


def render_step(state: RenderState, scene, camera,
                config: RenderConfig, stats=None) -> RenderState:
    """One progressive step: add ``config.samples_per_step`` samples.

    ``state.accum`` is updated IN PLACE (the returned state holds the same
    tensor), the analogue of the JAX engine's donated buffer. ``stats``
    as in ``megakernel.render_samples``. One step is one
    ``engine.step`` span (``utils.metrics``)."""
    with metrics.step():
        sample = megakernel.render_samples(
            scene, camera, config, sample_start=state.spp,
            n_samples=config.samples_per_step, seed=state.seed, stats=stats,
        )
        state.accum.add_(sample)
    return RenderState(accum=state.accum,
                       spp=state.spp + config.samples_per_step,
                       seed=state.seed)


def resolve(state: RenderState) -> torch.Tensor:
    """Mean radiance image from the running sum, (H, W, 3) f32 linear."""
    return state.accum / float(max(state.spp, 1))


def resolve_preview(state: RenderState, factor: int) -> torch.Tensor:
    """``resolve`` mean-pooled by ``factor`` on the device, for a live
    preview that copies a factor²-smaller image to the host. Edge rows and
    columns short of a full pool window are cropped (file writes always
    use ``resolve``)."""
    img = resolve(state)
    h, w, _ = img.shape
    hc, wc = (h // factor) * factor, (w // factor) * factor
    pooled = img[:hc, :wc].reshape(hc // factor, factor, wc // factor,
                                   factor, 3)
    return pooled.mean(dim=(1, 3))


def render_once(scene, camera, config: RenderConfig) -> torch.Tensor:
    """Single-shot render at ``config.samples_per_pixel`` (mean radiance)."""
    sample = megakernel.render_samples(
        scene, camera, config, sample_start=0,
        n_samples=config.samples_per_pixel, seed=int(config.seed),
    )
    return sample / float(config.samples_per_pixel)
