"""Benchmark entry point: Mrays/s of one scene on one CUDA device.

    python -m pathtracing_tpu_torch.bench

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"}, the keys
of the JAX package's root ``bench.py``. The flagship configuration is the
same: ``cornell_mesh(6)`` (81,920 mesh triangles), 1920x1080, depth 8,
the megakernel engine, NEE with MIS, 1 spp a progressive step. One
warm-up step, then the timed steps end in ``torch.cuda.synchronize()``.

Rays are the segments the engine that ran traced in the timed steps:
every bounce's closest-hit rays plus the NEE shadow rays (area-light,
environment and delta waves), from the engine's ``stats`` (the
megakernel's per-bounce counts, or the wavefront's live slots per
iteration; both count the same paths). ``vs_baseline`` is null: the JAX
package's 200 Mrays/s is a TPU target, not this card's.

Env knobs:
  BENCH_SCENE   (default cornell_mesh) one of ``models.scenes.SCENES``;
                cornell_mesh means cornell_mesh(6) (4 with BENCH_QUICK)
  BENCH_WIDTH / BENCH_HEIGHT (default 1920 / 1080)
  BENCH_STEPS   (default 4) timed 1-spp steps after the warm-up
  BENCH_DEPTH   (default 8)
  BENCH_ENGINE  (default megakernel) ``megakernel`` or ``wavefront``
  BENCH_QUICK=1 a small configuration (256x256, 1 step, depth 4)

With no CUDA device it exits non-zero at once and says so.
"""

from __future__ import annotations

import json
import os
import sys
import time


def bench_config(env=os.environ):
    """(scene name, width, height, timed steps, depth, quick) from the
    environment knobs."""
    quick = env.get("BENCH_QUICK", "0") == "1"
    return (env.get("BENCH_SCENE", "cornell_mesh"),
            int(env.get("BENCH_WIDTH", 256 if quick else 1920)),
            int(env.get("BENCH_HEIGHT", 256 if quick else 1080)),
            int(env.get("BENCH_STEPS", 1 if quick else 4)),
            int(env.get("BENCH_DEPTH", 4 if quick else 8)),
            quick)


ENGINES = ("megakernel", "wavefront")


def bench_engine(env=os.environ) -> str:
    """The ``BENCH_ENGINE`` knob: ``megakernel`` (default) or
    ``wavefront``."""
    engine = env.get("BENCH_ENGINE", "megakernel")
    if engine not in ENGINES:
        raise ValueError(f"BENCH_ENGINE must be one of {ENGINES}, not "
                         f"{engine!r}")
    return engine


def load_scene(name: str, quick: bool, device=None):
    """(scene, camera config) of ``BENCH_SCENE`` through the registry;
    ``cornell_mesh`` is the flagship's cornell_mesh(6) (4 when quick)."""
    from pathtracing_tpu_torch.models import scenes

    if name == "cornell_mesh":
        return scenes.cornell_mesh(4 if quick else 6, device=device)
    return scenes.get_scene(name, device=device)


def run(env=os.environ) -> dict:
    """Time the configured render on the card; returns the JSON line's
    object."""
    import torch

    from pathtracing_tpu_torch.models import progressive, scenes, wavefront
    from pathtracing_tpu_torch.ops.camera import build_camera
    from pathtracing_tpu_torch.utils.config import RenderConfig

    name, width, height, n_steps, depth, quick = bench_config(env)
    engine = bench_engine(env)
    step = (wavefront.render_step if engine == "wavefront"
            else progressive.render_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    scene, cam_cfg = load_scene(name, quick)
    camera = build_camera(cam_cfg, width / height)
    config = RenderConfig(
        width=width, height=height, samples_per_pixel=n_steps + 1,
        max_depth=depth, samples_per_step=1, seed=0, engine=engine,
        background=scenes.preferred_background(name),
    )
    state = progressive.init_state(config)
    state = step(state, scene, camera, config)
    torch.cuda.synchronize()

    stats = {}
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state = step(state, scene, camera, config, stats=stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    segments = int(stats["segments"]) + int(stats["shadow_segments"])
    mrays = segments / dt / 1e6
    return {
        "metric": f"Mrays/s ({name} {width}x{height} depth{depth} "
                  f"{engine}, {torch.cuda.get_device_name(0)}, "
                  f"avg_path={segments / n_steps / (width * height):.2f})",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "vs_baseline": None,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pathtracing_tpu_torch.bench: no CUDA device; the benchmark "
              "times the card and has no CPU fallback", file=sys.stderr)
        return 1
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
