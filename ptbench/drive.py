"""What every closed loop shares. A traffic mix (``traffic/<name>.json``)
is data: its ``loop`` names a loop module (``loops/<loop>.py``), its other
keys are that loop's parameters (and ``check_pixels``, the pixels the
check samples). A loop module gives

* ``setup(cell) -> ctx``: the warm-up at the cell's own shapes;
* ``window(cell, ctx, seconds) -> record``: the measured window, one
  client issuing the next frame or render when the last is done;
  ``record`` holds ``window_s`` and ``samples`` and whatever its
  metrics' readers read;
* ``answers(cell, ctx)``: what the window produced, for the check;
* ``compare(ref, answers, config, traffic, seed) -> numbers``: the
  numbers compared, with ``attempted`` and ``failed``;
* ``LIMITS``: each number's limit (``PERF.md`` gives the readings)."""

from __future__ import annotations

from dataclasses import dataclass

M63 = (1 << 63) - 1


def render_seed(seed: int, i: int) -> int:
    """The seed of render ``i`` of a run (the port's seeds are 64-bit)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + i * 0xD1B54A32D192ED03
            + 1) & M63 if i else int(seed) & M63


@dataclass
class Cell:
    """What set-up built for the loop."""

    device: object
    scene: object
    camera: object
    config: dict
    traffic: dict
    seed: int
    sync: object
    trace: bool
    profile_units: int = 0


def render_config(cell: Cell, seed: int):
    """The port's RenderConfig of the cell (an open-ended spp: the window,
    or the scheduler's budget, decides how many samples are rendered)."""
    from pathtracing_tpu_torch.utils.config import RenderConfig

    c = cell.config
    return RenderConfig(
        width=c["width"], height=c["height"], samples_per_pixel=1 << 30,
        max_depth=c["max_depth"], rr_start_depth=c["rr_start_depth"],
        seed=seed, samples_per_step=cell.traffic.get("spp", 1),
        engine=c["engine"], background=c["background"], nee=c["nee"],
        nee_candidates=c["nee_candidates"], sampler=c["sampler"],
        dtype=c["dtype"])
