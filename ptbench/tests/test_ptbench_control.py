"""The check must fail its control and the timed path's faults (CPU, at
a size a test run holds; the control at the cells' own sizes runs on the
card: ``python3 -m ptbench.calibrate``)."""

import pytest
import torch

from ptbench import calibrate, spec
from ptbench.tests import _tiny

PROGRESSIVE = "cornell_mesh6.progressive"
ADAPTIVE = "cornell_mesh6.adaptive"
WAVEFRONT = "cornell_mesh6.wavefront"


@pytest.mark.parametrize("seed", [2**31 + 5, 2**34 + 17, 3])
def test_the_bfloat16_control_fails_a_limit(seed):
    nums = calibrate.control_numbers(spec.load(), PROGRESSIVE, seed, 4, "cpu",
                                     overrides=_tiny.overrides(), pixels=64)
    limits = _tiny.limits()
    assert (nums["median_gap"] > limits["median_gap"]
            or nums["off_share"] > limits["off_share"]), nums


@pytest.mark.card
def test_the_bfloat16_control_fails_on_the_card(card):
    nums = calibrate.control_numbers(spec.load(), PROGRESSIVE, 7, 16, "cuda",
                                     pixels=256)
    assert nums["median_gap"] > _tiny.limits()["median_gap"]


def _unchanged_step(state, scene, camera, config, stats=None):
    """Renders the step's samples and drops them: the state comes back
    as it was, but for its sample count."""
    from pathtracing_tpu_torch.models import megakernel, progressive

    megakernel.render_samples(scene, camera, config, sample_start=state.spp,
                              n_samples=config.samples_per_step,
                              seed=state.seed, stats=stats)
    return progressive.RenderState(state.accum,
                                   state.spp + config.samples_per_step,
                                   state.seed)


def _unchanged_wavefront_step(state, scene, camera, config, stats=None):
    """The wavefront's step rendered into a scratch image: the state
    comes back as it was, but for its sample count."""
    from pathtracing_tpu_torch.models import progressive, wavefront

    scratch = torch.zeros_like(state.accum)
    wavefront.render_wave(scene, camera, config, scratch.view(-1, 3),
                          sample_start=state.spp,
                          n_samples=config.samples_per_step, seed=state.seed,
                          stats=stats)
    return progressive.RenderState(state.accum,
                                   state.spp + config.samples_per_step,
                                   state.seed)


def _unchanged_tile_step(state, *args, **kwargs):
    return state


def _half_batch(fn):
    def traced(*args, **kwargs):
        rad = fn(*args, **kwargs)
        return torch.where((torch.arange(rad.shape[0]) % 2 == 0)[:, None],
                           rad, 0.0)
    return traced


def _half_deposit(fn):
    def deposit(accum_flat, pixel, value, unique):
        keep = (torch.arange(value.shape[0]) % 2 == 0)[:, None]
        return fn(accum_flat, pixel, torch.where(keep, value, 0.0), unique)
    return deposit


def _altered_deposit(fn):
    def deposit(accum_flat, pixel, value, unique):
        return fn(accum_flat, pixel, value + torch.tensor([0.0, 1e-3, 0.0]),
                  unique)
    return deposit


def _altered(fn):
    def rendered(*args, **kwargs):
        out = fn(*args, **kwargs)
        return out + torch.tensor([0.0, 1e-3, 0.0])
    return rendered


def _worst_k(scores, k):
    return torch.sort(scores, descending=False, stable=True).indices[:k]


FAULTS = {
    "state_unchanged": {
        PROGRESSIVE: ("progressive", "render_step", lambda f: _unchanged_step),
        ADAPTIVE: ("adaptive", "tile_step", lambda f: _unchanged_tile_step),
        WAVEFRONT: ("wavefront", "render_step",
                    lambda f: _unchanged_wavefront_step)},
    "half_the_batch": {
        PROGRESSIVE: ("megakernel", "_trace_pixels", _half_batch),
        ADAPTIVE: ("megakernel", "_trace_pixels", _half_batch),
        WAVEFRONT: ("wavefront", "_deposit", _half_deposit)},
    "answer_altered": {
        PROGRESSIVE: ("megakernel", "render_samples", _altered),
        ADAPTIVE: ("megakernel", "render_samples", _altered),
        WAVEFRONT: ("wavefront", "_deposit", _altered_deposit)},
    "wrong_picks": {ADAPTIVE: ("adaptive", "top_k", lambda f: _worst_k)},
}


def test_a_fault_after_the_snapshot_fails_the_final_limits(monkeypatch):
    """The snapshot at the warm frame's one sample, then a window frame
    that drops its samples: the final accumulator's limits fail."""
    from pathtracing_tpu_torch.models import progressive

    real = progressive.render_step

    def step(state, *args, **kwargs):
        late = state.spp >= 1
        return (_unchanged_step if late else real)(state, *args, **kwargs)

    monkeypatch.setattr(progressive, "render_step", step)
    seen = _tiny.recording_answers(monkeypatch)
    res = _tiny.run_tiny(PROGRESSIVE, seconds=0.0, traffic={"check_spp": 1})
    assert seen[-1]["spp"] > seen[-1]["snapshot_spp"] == 1
    limits = _tiny.limits()
    got = {n: row["value"] for n, row in res["compared"].items()}
    assert (got["median_gap"] > limits["median_gap"]
            or got["off_share"] > limits["off_share"]), got
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("cell", [PROGRESSIVE, ADAPTIVE, WAVEFRONT])
def test_a_sound_tiny_run_is_correct(cell):
    res = _tiny.run_tiny(cell)
    assert res["correct"], res["compared"]


@pytest.mark.parametrize("fault,cell", [(f, c) for f, cells in FAULTS.items()
                                        for c in cells])
def test_a_fault_in_the_timed_path_makes_the_run_incorrect(fault, cell,
                                                           monkeypatch):
    import importlib

    module, attr, wrap = FAULTS[fault][cell]
    mod = importlib.import_module(f"pathtracing_tpu_torch.models.{module}")
    monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    res = _tiny.run_tiny(cell)
    assert not res["correct"], res["compared"]
