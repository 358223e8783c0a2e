"""CLI entry point: ``python -m pathtracing_tpu_torch.render`` (the JAX
package's ``render.py``).

A headless driver: a progressive render loop with a periodic "present"
(an image snapshot), checkpoint and resume, per-step metrics and an
optional ``torch.profiler`` trace; band-tiled renders with recovery,
the adaptive schedulers, turntable orbits with temporal reuse, AOV
passes and the post-passes. A live preview window is optional
(matplotlib, if installed).

The render runs on the card unless ``--device`` names another device
(``--device cpu`` runs the plain torch path); without a GPU and without
``--device cpu`` the CLI exits 2 and says why. ``--debug`` picks the
plain torch route and checks after every step that the accumulator is
finite (the JAX package turns on ``jax_debug_nans``).

Under ``torchrun`` (``torchrun --nproc_per_node=N -m
pathtracing_tpu_torch.render``) the progressive render is sharded over
the ranks (``parallel/``): one process per card, NCCL, or gloo with
``--device cpu``; ``--samples`` ranks share each step's samples and the
rest split the image rows; rank 0 writes the image.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import signal
import sys

import numpy as np
import torch
import torch.distributed as dist

from pathtracing_tpu_torch.models import progressive, scenes
from pathtracing_tpu_torch.ops.camera import build_camera
from pathtracing_tpu_torch.parallel.mesh import multihost_init
from pathtracing_tpu_torch.utils import checkpoint as ckpt
from pathtracing_tpu_torch.utils import image, metrics
from pathtracing_tpu_torch.utils import logging as ptlog
from pathtracing_tpu_torch.utils.config import (TRAVERSALS, RenderConfig,
                                                resolve_device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pathtracing_tpu_torch.render",
        description="progressive path tracer (PyTorch/CUDA)",
    )
    p.add_argument("--scene", default="cornell_bsdf",
                   help="built-in scene (%s), 'reference' for the exact "
                        "reference kernel image (Test.hlsl parity), or a "
                        "path to a .json, .gltf, .glb or .obj scene file"
                        % ", ".join(sorted(scenes.SCENES)))
    p.add_argument("--device", default=None,
                   help="torch device to render on (default: the CUDA "
                        "card; 'cpu' runs the plain torch path)")
    p.add_argument("--samples", type=int, default=1,
                   help="sharded renders under torchrun: ranks that share "
                        "each step's samples (their sums are added); the "
                        "others split the image rows (default 1)")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=256, help="total samples/pixel")
    p.add_argument("--spp-per-step", type=int, default=8)
    p.add_argument("--max-depth", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--engine", default="megakernel",
                   choices=["megakernel", "wavefront"])
    p.add_argument("--background", default="auto",
                   choices=["auto", "black", "gradient", "white"],
                   help="sky radiance for escaped rays; 'auto' (default) "
                        "uses the scene's preferred background — the "
                        "gradient sky for emitter-free outdoor scenes "
                        "(checker/sphere/glass/frosted demos, or a JSON "
                        "scene's top-level \"background\" key), black "
                        "otherwise")
    p.add_argument("--aov", default=None,
                   choices=["normal", "depth", "albedo", "mat_id"],
                   help="render a single diagnostic pass instead of the "
                        "path-traced image (the 'normal' AOV is the "
                        "reference kernel's shading generalized to any "
                        "scene, Test.hlsl:26-32)")
    p.add_argument("--aperture", type=float, default=None,
                   help="override the scene camera's aperture "
                        "(thin-lens depth of field)")
    p.add_argument("--focus-distance", type=float, default=None,
                   help="override the scene camera's focus distance")
    p.add_argument("--projection", default=None,
                   choices=["pinhole", "ortho", "fisheye", "equirect"],
                   help="override the scene camera's projection model "
                        "(equirect renders a 360x180 lat-long panorama "
                        "that ops/envmap.py can re-light scenes with)")
    p.add_argument("--motion-to", default=None, metavar="X,Y,Z",
                   help="camera motion blur: position at shutter close "
                        "(per-sample shutter times lerp the pose)")
    p.add_argument("--motion-look-to", default=None, metavar="X,Y,Z",
                   help="camera motion blur: look_at at shutter close")
    p.add_argument("--fog-sigma-s", type=float, default=0.0,
                   help="fill the scene with scattering fog: "
                        "scattering coefficient per world unit")
    p.add_argument("--fog-sigma-a", type=float, default=0.0,
                   help="fog absorption coefficient")
    p.add_argument("--fog-g", type=float, default=0.0,
                   help="fog Henyey-Greenstein anisotropy in (-1, 1)")
    p.add_argument("--nee-candidates", type=int, default=1, metavar="M",
                   help="RIS candidate count for the NEE light pick: M "
                        "power-CDF candidates resampled by unshadowed "
                        "contribution down to ONE shadow ray (default 1 "
                        "= plain power-weighted NEE; try 4-8 on "
                        "many-light scenes)")
    p.add_argument("--no-nee", action="store_true",
                   help="disable next-event estimation (direct light "
                        "sampling); brute-force path tracing only")
    p.add_argument("--traversal", default="auto",
                   choices=["auto", *TRAVERSALS],
                   help="intersection backend (auto: the CUDA cluster "
                        "kernels on the card, their plain torch versions "
                        "on the CPU or with --debug)")
    p.add_argument("--out", default="render.png",
                   help="output path: .png (tonemapped), .ppm, .exr or "
                        ".hdr (LINEAR radiance — no tone curve)")
    p.add_argument("--out-hdr", default=None,
                   help="also write the linear HDR radiance (.npz with "
                        "'radiance' (H,W,3) f32 and 'spp')")
    p.add_argument("--tonemap", default="clip",
                   choices=["clip", "aces", "reinhard", "filmic"],
                   help="display transform: 'clip' (plain sRGB clamp — "
                        "the reference swapchain's behavior) or a filmic "
                        "highlight rolloff")
    p.add_argument("--exposure", type=float, default=1.0,
                   help="linear exposure multiplier applied before the "
                        "tone curve")
    p.add_argument("--clamp", type=float, default=0.0,
                   help="per-sample radiance clamp (firefly suppression; "
                        "0 = unbiased/off)")
    p.add_argument("--bloom", type=float, default=0.0, metavar="S",
                   help="bloom glow strength (linear-radiance additive "
                        "post-pass, ops/bloom.py; 0 disables, ~0.05-0.2 "
                        "is typical)")
    p.add_argument("--bloom-threshold", type=float, default=1.0,
                   help="luminance above which radiance blooms "
                        "(soft knee below it; default 1.0)")
    p.add_argument("--denoise", action="store_true",
                   help="edge-avoiding à-trous denoise of the final "
                        "image, guided by first-hit normal/albedo/depth "
                        "feature buffers (ops/denoise.py)")
    p.add_argument("--denoise-iters", type=int, default=5,
                   help="à-trous iterations (dilations 1,2,4,...)")
    p.add_argument("--denoise-sigma-color", type=float, default=None,
                   help="color range sigma (default: 2.8/sqrt(spp))")
    p.add_argument("--temporal", action="store_true",
                   help="orbit sequences only: reproject and blend the "
                        "previous frames' accumulated history into each "
                        "new frame (models/temporal.py; compose with "
                        "--denoise for the full SVGF-style pipeline)")
    p.add_argument("--temporal-cap", type=float, default=16.0,
                   help="max effective frames of blended history "
                        "(higher = smoother, more motion staleness)")
    p.add_argument("--mips", action="store_true",
                   help="rebuild the scene's texture atlas with a mip "
                        "pyramid and sample trilinearly at ray-cone LOD "
                        "(ops/texture.py; fixes minification aliasing "
                        "on textured geometry at distance)")
    p.add_argument("--snapshot-every", type=int, default=0,
                   help="write the image every N steps (0 = only at end)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file; resumes if it exists")
    p.add_argument("--tiles", type=int, default=0,
                   help="render in N independent row bands with per-band "
                        "completion tracking (resume re-renders only "
                        "missing bands)")
    p.add_argument("--inject-fault", type=int, default=None,
                   help="debug: drop band N mid-render to exercise the "
                        "tile recovery path (requires --tiles)")
    p.add_argument("--adaptive", action="store_true",
                   help="variance-driven sample allocation: per-pixel "
                        "variance scores schedule each round's rays onto "
                        "the noisiest 8x8 tiles (models/adaptive.py; the "
                        "spp budget is the uniform-equivalent total). "
                        "With --tiles: the coarser host-driven per-band "
                        "scheduler instead")
    p.add_argument("--adaptive-granularity", default="tiles",
                   choices=["tiles", "bands"],
                   help="adaptive scheduling unit: square tiles (default; "
                        "follows 2D-compact noise) or full row bands "
                        "(the coarser fallback — auto-selected when the "
                        "image isn't divisible by the tile size)")
    p.add_argument("--adaptive-tile", type=int, default=8,
                   help="tile edge for tile-granular adaptive scheduling "
                        "(must divide width and height)")
    p.add_argument("--adaptive-auto", type=float, default=1.5,
                   metavar="GAIN",
                   help="never-lose guard for tile-granular --adaptive: "
                        "after the warmup, if the scene's Neyman gain "
                        "bound (models/adaptive.tile_neyman_gain) is "
                        "below this threshold, the remaining budget "
                        "renders as plain uniform full-image samples "
                        "(same sample ids). 0 disables")
    p.add_argument("--adaptive-band-rows", type=int, default=0,
                   help="rows per adaptive scheduling band (0 = auto, "
                        "largest divisor of height <= 8)")
    p.add_argument("--target-rmse", type=float, default=0.0,
                   help="render-until-quality stop for tile-granular "
                        "--adaptive: stop as soon as the live "
                        "standard-error estimate "
                        "(models/adaptive.predicted_rmse, RMSE vs "
                        "converged) reaches this value; --spp becomes a "
                        "budget cap. 0 disables")
    p.add_argument("--adaptive-k", type=int, default=0,
                   help="tiles/bands re-sampled per adaptive round "
                        "(0 = auto, 1/8 of the units)")
    p.add_argument("--checkpoint-every", type=int, default=8,
                   help="checkpoint every N steps")
    p.add_argument("--metrics-jsonl", default=None)
    p.add_argument("--profile", default=None,
                   help="capture a torch.profiler trace (trace.json) into "
                        "this directory")
    p.add_argument("--orbit", type=int, default=0,
                   help="turntable mode: render N frames orbiting the "
                        "scene's look-at point (the frame-loop analogue "
                        "of the reference's windowed render loop, "
                        "App.cs:39-42); writes <out>_0000.png .. "
                        "<out>_NNNN.png")
    p.add_argument("--orbit-degrees", type=float, default=360.0,
                   help="arc swept by --orbit, centered on the scene "
                        "camera's position (default 360 = full turn; "
                        "use a partial arc for interior scenes like the "
                        "Cornell box, whose outside is black)")
    p.add_argument("--preview", action="store_true",
                   help="live preview via matplotlib (if installed)")
    p.add_argument("--preview-scale", type=int, default=0, metavar="F",
                   help="preview downsample factor (device-side mean "
                        "pool; 0 = auto: longest side <= ~480 px)")
    p.add_argument("--preview-every", type=int, default=1, metavar="N",
                   help="update the preview every N steps (default 1)")
    p.add_argument("--debug", action="store_true",
                   help="plain torch traversal and a finite-radiance check "
                        "after every step (reference DEBUG-validation "
                        "analogue)")
    return p


def _load_scene(args, device):
    """(scene, camera config, preferred background), or None after logging
    why the scene could not be loaded."""
    path = args.scene
    try:
        if path.endswith(".json"):
            from pathtracing_tpu_torch.models import scene_io

            scene, cam_cfg = scene_io.load_scene(path, device=device)
            return scene, cam_cfg, scene_io.preferred_background(path)
        if path.endswith((".gltf", ".glb", ".obj")):
            if path.endswith(".obj"):
                from pathtracing_tpu_torch.models import obj_mtl

                scene, cam_cfg = obj_mtl.load_obj_scene(path, device=device)
            else:
                from pathtracing_tpu_torch.models import gltf

                scene, cam_cfg = gltf.load_gltf(path, device=device)
            # Assets with no emitter of any kind need a sky to be visible.
            has_light = (float(scene.lights.total_power) > 0.0
                         or scene.delta is not None or scene.env is not None)
            return scene, cam_cfg, "black" if has_light else "gradient"
    except (OSError, ValueError, KeyError) as e:
        ptlog.log_critical("failed to load scene %s: %s", path, e)
        return None
    try:
        scene, cam_cfg = scenes.get_scene(path, device=device)
    except KeyError as e:
        ptlog.log_critical("%s", e.args[0])
        return None
    return scene, cam_cfg, scenes.preferred_background(path)


def _vec3(text):
    parts = [float(x) for x in text.split(",")]
    if len(parts) != 3:
        raise SystemExit(f"expected X,Y,Z; got {text!r}")
    return tuple(parts)


def _start_fetch(img):
    """Start copying ``img`` (a tensor no later step writes) to the host:
    (host tensor, CUDA event or None). On the card the copy goes into
    pinned memory without blocking and the event marks its end; wait on
    it only when the image is needed, after the next step is queued."""
    if img.device.type != "cuda":
        return img, None
    host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
    host.copy_(img, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


@contextlib.contextmanager
def _interrupts_between_steps():
    """Yield a list that a Ctrl-C (SIGINT) appends to instead of raising,
    so the loop stops between steps: ``render_step`` adds to the
    accumulator in place, and a step cut short could leave a sample in the
    sum that ``spp`` does not count, in the checkpoint written on the way
    out. Outside the main thread Ctrl-C is left alone."""
    caught = []
    try:
        old = signal.signal(signal.SIGINT, lambda sig, frame:
                            caught.append(sig))
    except ValueError:
        yield caught
        return
    try:
        yield caught
    finally:
        signal.signal(signal.SIGINT, old)


def _unsharded_flags(args):
    """The flags of branches that a sharded render does not take."""
    return [flag for flag, on in (
        ("--scene reference", args.scene == "reference"),
        ("--aov", args.aov), ("--orbit", args.orbit),
        ("--tiles", args.tiles), ("--adaptive", args.adaptive),
        ("--target-rmse", args.target_rmse),
        ("--checkpoint", args.checkpoint),
        ("--snapshot-every", args.snapshot_every),
        ("--preview", args.preview), ("--profile", args.profile),
        ("--debug", args.debug)) if on]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        # Under torchrun: join its process group, on this rank's device.
        ranked = multihost_init(args.device)
        device = (ranked if ranked is not None
                  else resolve_device(args.device))
    except RuntimeError as e:
        ptlog.log_critical("%s (the CLI flag is --device cpu)", e)
        return 2
    if ranked is None:
        if args.samples != 1:
            ptlog.log_critical(
                "--samples shards a render over torchrun's ranks; launch "
                "with torchrun --nproc_per_node=N")
            return 2
        return _render(args, device, sharded=False)
    try:
        flags = _unsharded_flags(args)
        if flags:
            ptlog.log_critical(
                "a sharded render (torchrun) runs progressive steps only; "
                "it cannot take %s", ", ".join(flags))
            return 2
        return _render(args, device, sharded=True)
    finally:
        dist.destroy_process_group()


def _step_metrics(config, step, spp, seconds, stats=None):
    """The step's log line. ``stats``: the engine's counts of the step
    (``segments`` and ``shadow_segments``), read after the ``Timer``'s
    synchronise: Mrays/s counts the rays traced. Without them (the sharded
    step, whose rank counts only its own rays) it falls back to
    ``metrics.rays_per_sample``, ``max_depth`` rays a path, an upper
    bound."""
    if stats:
        rays = sum(metrics.host_read("cli.rays", int, stats.get(k, 0))
                   for k in ("segments", "shadow_segments"))
    else:
        rays = metrics.rays_per_sample(
            config.width, config.height, config.max_depth
        ) * config.samples_per_step
    return metrics.StepMetrics(
        step=step, seconds=seconds, samples_added=config.samples_per_step,
        total_spp=spp, mrays_per_s=rays / seconds / 1e6,
        samples_per_s=config.width * config.height
        * config.samples_per_step / seconds,
    )


def _log_idle_by_span(prof) -> None:
    """Why the card sat idle in the profiled steps: its idle ms under each
    innermost port span (``metrics.idle_by_span``), and the steps' host
    syncs and host wait."""
    steps = metrics.steps()
    if not steps:
        return
    syncs = sorted(s["host_syncs"] for s in steps)
    wait = sorted(s["host_wait_ns"] * 1e-6 for s in steps)
    ptlog.log_information(
        "profiled steps: %d; host syncs a step %d to %d; host wait %.3f to "
        "%.3f ms a step", len(steps), syncs[0], syncs[-1], wait[0], wait[-1])
    table = metrics.idle_by_span(prof.profiler.kineto_results.events(),
                                 metrics.records())
    ptlog.log_information(
        "device idle ms by port span (last %d steps): %s",
        min(len(steps), metrics.RAW_STEPS),
        ", ".join(f"{n} {ms:.3f}" for n, ms in table.items()) or "none")


def _render(args, device, sharded: bool) -> int:
    if args.debug:
        ptlog.log_information(
            "debug mode: plain torch route, finite-radiance check after "
            "every step")
    ptlog.log_information("device: %s%s", device,
                          f" ({torch.cuda.get_device_name(device)})"
                          if device.type == "cuda" else "")

    if args.scene == "reference":
        from pathtracing_tpu_torch.models.reference import render_reference

        img = render_reference(args.height, args.width, device=device)
        image.write_image(args.out, img[..., :3])
        ptlog.log_information("wrote reference-parity image to %s", args.out)
        return 0

    loaded = _load_scene(args, device)
    if loaded is None:
        return 2
    scene, cam_cfg, scene_bg = loaded
    if args.mips and scene.textures is not None:
        from pathtracing_tpu_torch.ops import texture

        scene = scene._replace(textures=texture.add_mips(scene.textures))
    background = scene_bg if args.background == "auto" else args.background
    config = RenderConfig(
        width=args.width, height=args.height,
        samples_per_pixel=args.spp, max_depth=args.max_depth,
        seed=args.seed, samples_per_step=args.spp_per_step,
        engine=args.engine, background=background,
        nee=not args.no_nee, traversal=args.traversal,
        nee_candidates=args.nee_candidates,
        clamp=args.clamp, debug=args.debug,
    )
    if args.fog_sigma_s > 0.0 or args.fog_sigma_a > 0.0:
        # Fill any scene with a homogeneous scattering medium.
        scene = scene._replace(fog=torch.tensor(
            [args.fog_sigma_s, args.fog_sigma_a, args.fog_g],
            dtype=torch.float32, device=device))
    if (args.aperture is not None or args.focus_distance is not None
            or args.projection is not None):
        cam_cfg = dataclasses.replace(
            cam_cfg,
            aperture=(args.aperture if args.aperture is not None
                      else cam_cfg.aperture),
            focus_distance=(args.focus_distance
                            if args.focus_distance is not None
                            else cam_cfg.focus_distance),
            projection=(args.projection if args.projection is not None
                        else cam_cfg.projection),
        )
    if args.motion_to is not None or args.motion_look_to is not None:
        cam_cfg = dataclasses.replace(
            cam_cfg,
            motion_position=(_vec3(args.motion_to)
                             if args.motion_to is not None
                             else cam_cfg.motion_position),
            motion_look_at=(_vec3(args.motion_look_to)
                            if args.motion_look_to is not None
                            else cam_cfg.motion_look_at),
        )
    motion = cam_cfg.motion_pair()
    if motion is not None and args.orbit:
        ptlog.log_warning("--orbit ignores camera motion blur")
    aspect = args.width / args.height
    if motion is not None:
        camera = (build_camera(motion[0], aspect, device=device),
                  build_camera(motion[1], aspect, device=device))
    else:
        camera = build_camera(cam_cfg, aspect, device=device)

    if sharded:
        if args.engine == "wavefront":
            ptlog.log_warning(
                "a sharded render always renders via the megakernel "
                "engine; --engine wavefront is ignored"
            )
        return _sharded_main(args, config, scene, camera, device)

    if args.target_rmse > 0.0 and not args.adaptive:
        # Checked before the --aov/--orbit/--tiles branches, which return
        # early and would otherwise ignore the flag.
        ptlog.log_critical(
            "--target-rmse needs the per-pixel variance state: "
            "pass --adaptive (tile granularity)"
        )
        return 2
    if args.target_rmse > 0.0 and (args.aov or args.orbit or args.tiles):
        # The JAX CLI renders these branches and ignores both flags.
        ptlog.log_critical(
            "--adaptive --target-rmse applies to the adaptive render "
            "only; it cannot be combined with --aov, --orbit or --tiles"
        )
        return 2

    if args.aov:
        from pathtracing_tpu_torch.models import aov

        img = aov.render_aov(scene, camera, config, args.aov)
        image.write_image(args.out, img)
        ptlog.log_information("wrote %s AOV to %s", args.aov, args.out)
        return 0

    if args.orbit:
        if args.engine == "wavefront":
            ptlog.log_warning(
                "--orbit always renders frames via the megakernel "
                "engine; --engine wavefront is ignored for orbits"
            )
        return _orbit_main(args, config, scene, cam_cfg, device)

    if args.tiles:
        if args.engine == "wavefront":
            ptlog.log_warning(
                "--tiles always renders via the megakernel engine; "
                "--engine wavefront is ignored for tiled renders"
            )
        return _tiled_main(args, config, scene, camera)

    if args.adaptive:
        if args.engine == "wavefront":
            ptlog.log_warning(
                "--adaptive renders band waves via the megakernel "
                "engine; --engine wavefront is ignored"
            )
        return _adaptive_main(args, config, scene, camera)

    if args.engine == "wavefront":
        from pathtracing_tpu_torch.models import wavefront

        step_fn = wavefront.render_step
    else:
        step_fn = progressive.render_step

    state = progressive.init_state(config, device=device)
    if args.checkpoint and os.path.exists(args.checkpoint):
        try:
            state = ckpt.load(args.checkpoint, config, device=device)
        except ValueError as e:
            ptlog.log_critical("%s", e)
            return 2
        ptlog.log_information(
            "resumed from %s at %d spp", args.checkpoint, state.spp
        )

    mlog = metrics.MetricsLog(jsonl_path=args.metrics_jsonl)
    preview = _Preview() if args.preview else None
    # Preview-only snapshots are pooled on the device, so the host copy
    # stays small; snapshots written to a file are full size.
    prev_factor = args.preview_scale
    if prev_factor <= 0:
        prev_factor = max(1, -(-max(config.width, config.height) // 480))

    prof = None
    if args.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        metrics.reset()
        metrics.enable(ranges=True)
        prof.start()

    step = state.spp // config.samples_per_step
    # Asynchronous present: a snapshot is resolved into a new tensor and
    # its copy to the host started before the next step is queued; the
    # host waits for the copy and encodes the image only after queuing
    # that step, so the encode overlaps the card's work.
    pending = None  # (host image, copy event, spp, write the file?)
    with _interrupts_between_steps() as sigint:
        try:
            while state.spp < config.samples_per_pixel:
                if sigint:
                    raise KeyboardInterrupt
                stats = {}
                with metrics.Timer(device) as t:
                    state = step_fn(state, scene, camera, config,
                                    stats=stats)
                    if pending is not None:
                        host, done, psnap_spp, do_file = pending
                        if done is not None:
                            done.synchronize()
                        if do_file:
                            image.write_image(args.out, host, args.exposure,
                                              args.tonemap)
                        if preview is not None:
                            preview.update(host, psnap_spp)
                        pending = None
                step += 1
                if args.debug and not bool(
                        torch.isfinite(state.accum).all()):
                    ptlog.log_critical(
                        "debug: non-finite radiance after step %d (%d spp)",
                        step, state.spp)
                    return 2
                mlog.record(_step_metrics(config, step, state.spp,
                                          t.seconds, stats))
                if args.checkpoint and step % args.checkpoint_every == 0:
                    ckpt.save(args.checkpoint, state, config)
                do_file = bool(args.snapshot_every
                               and step % args.snapshot_every == 0)
                want_preview = (preview is not None
                                and step % max(args.preview_every, 1) == 0)
                if do_file or want_preview:
                    img = (progressive.resolve(state) if do_file else
                           progressive.resolve_preview(state, prev_factor))
                    pending = (*_start_fetch(img), state.spp, do_file)
            if pending is not None and pending[3]:
                if pending[1] is not None:
                    pending[1].synchronize()
                image.write_image(args.out, pending[0], args.exposure,
                                  args.tonemap)
                pending = None
        except KeyboardInterrupt:
            ptlog.log_warning("interrupted at %d spp", state.spp)
        finally:
            if prof is not None:
                prof.stop()
                metrics.disable()
                os.makedirs(args.profile, exist_ok=True)
                prof.export_chrome_trace(os.path.join(args.profile,
                                                      "trace.json"))
                ptlog.log_information("profile trace in %s", args.profile)
                _log_idle_by_span(prof)

    if args.checkpoint:
        ckpt.save(args.checkpoint, state, config)
    _write_final(args, config, scene, camera, progressive.resolve(state),
                 state.spp)
    ptlog.log_information(
        "wrote %s (%d spp, %d steps)", args.out, state.spp, step
    )
    return 0


def _sharded_main(args, config, scene, camera, device) -> int:
    """Progressive render sharded over the ranks torchrun started
    (parallel/render.py): each rank renders its stripe of image rows and
    its share of each step's samples; rank 0 writes the image."""
    from pathtracing_tpu_torch.parallel import mesh as mesh_mod
    from pathtracing_tpu_torch.parallel import render as prender

    try:
        mesh = mesh_mod.make_mesh(n_samples=args.samples, device=device)
        step_fn = prender.make_sharded_step(mesh, config)
    except ValueError as e:
        ptlog.log_critical("%s", e)
        return 2
    state = prender.init_sharded_state(mesh, config)
    mlog = metrics.MetricsLog(
        jsonl_path=args.metrics_jsonl if mesh.rank == 0 else None)
    step = 0
    while state.spp < config.samples_per_pixel:
        with metrics.Timer(device) as t:
            state = step_fn(state, scene, camera)
        step += 1
        mlog.record(_step_metrics(config, step, state.spp, t.seconds))
    final = prender.gather_image(state, mesh)
    if mesh.rank == 0:
        _write_final(args, config, scene, camera, final, state.spp)
        ptlog.log_information(
            "wrote %s (%d spp, %d steps, mesh %dx%d)", args.out, state.spp,
            step, mesh.n_tiles, mesh.n_samples)
    return 0


def _orbit_main(args, config, scene, cam_cfg, device) -> int:
    """Turntable frame sequence: the reference's continuous windowed
    render loop (`App.cs:39-42`), one megakernel render of
    ``samples_per_pixel`` samples a frame with a camera built on the
    device. Frame seeds differ (seed + frame) so animation noise is
    uncorrelated."""
    from pathtracing_tpu_torch.models import megakernel

    base = np.asarray(cam_cfg.position, np.float32)
    target = np.asarray(cam_cfg.look_at, np.float32)
    rel = base - target
    r_xz = math.hypot(float(rel[0]), float(rel[2]))
    phi0 = math.atan2(float(rel[0]), float(rel[2]))
    spp = config.samples_per_pixel

    root, ext = os.path.splitext(args.out)
    ext = ext or ".png"
    out_dir = os.path.dirname(root)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    n = args.orbit
    arc = math.radians(args.orbit_degrees)
    full_turn = abs(args.orbit_degrees) >= 360.0 - 1e-9
    tstate = cam_prev = None
    if args.temporal:
        from pathtracing_tpu_torch.models import temporal

        tstate = temporal.init_state(config, device=device)
    for i in range(n):
        # Full turns space frames over [0, arc) (frame n would repeat
        # frame 0); partial arcs sweep [-arc/2, +arc/2] inclusive,
        # centered on the scene camera.
        if full_turn:
            phi = phi0 + arc * i / n
        elif n == 1:
            phi = phi0
        else:
            phi = phi0 + arc * (i / (n - 1) - 0.5)
        pos = target + np.array(
            [r_xz * math.sin(phi), float(rel[1]), r_xz * math.cos(phi)],
            np.float32,
        )
        cc = dataclasses.replace(cam_cfg, position=tuple(map(float, pos)))
        camera = build_camera(cc, args.width / args.height, device=device)
        with metrics.Timer(device) as t:
            img = megakernel.render_samples(
                scene, camera, config, 0, spp, args.seed + i) / float(spp)
            if tstate is not None:
                # Blend the reprojected history into this frame.
                img, tstate = temporal.advance(
                    tstate, img, scene, camera,
                    camera if cam_prev is None else cam_prev,
                    config, cap=args.temporal_cap,
                )
                cam_prev = camera
        # Temporal frames carry blended history: their effective spp is
        # the per-frame budget times the mean history length (in
        # power-of-2 buckets), and the denoiser's color sigma narrows
        # with it. The history mean is read once a frame.
        spp_eff = spp
        if tstate is not None:
            hist = max(1.0, float(tstate.hist_len.mean()))
            if hist > 1.0:
                spp_eff *= 2 ** int(round(math.log2(hist)))
        img = _maybe_denoise(args, config, scene, camera, img, spp_eff)
        path = f"{root}_{i:04d}{ext}"
        image.write_image(path, img, args.exposure, args.tonemap)
        ptlog.log_information(
            "frame %d/%d -> %s (%.2fs, %.1f fps-equivalent)",
            i + 1, n, path, t.seconds, 1.0 / max(t.seconds, 1e-9),
        )
    return 0


def _maybe_denoise(args, config, scene, camera, img, spp):
    """The final-image post-passes: --denoise, then --bloom (both in
    linear radiance, before the tone curve)."""
    if args.denoise:
        from pathtracing_tpu_torch.ops import denoise

        img = denoise.denoise_render(
            scene, camera, config, img, spp=spp,
            iterations=args.denoise_iters,
            sigma_color=args.denoise_sigma_color,
        )
        ptlog.log_information(
            "denoised (%d à-trous iterations, %s spp)",
            args.denoise_iters, spp,
        )
    if args.bloom > 0.0:
        from pathtracing_tpu_torch.ops import bloom

        img = bloom.apply_bloom(img, args.bloom,
                                threshold=args.bloom_threshold)
        ptlog.log_information(
            "bloom applied (strength %.3g, threshold %.3g)",
            args.bloom, args.bloom_threshold,
        )
    return img


def _write_final(args, config, scene, camera, img, spp, spp_mean=None):
    """Write the final mean radiance: ``--out-hdr`` (at ``spp``, the
    least spp of any pixel), then the post-passes (at ``spp_mean``,
    default ``spp``) and ``--out``."""
    if args.out_hdr:
        np.savez(args.out_hdr, radiance=img.cpu().numpy(), spp=spp)
    final = _maybe_denoise(args, config, scene, camera, img,
                           spp if spp_mean is None else spp_mean)
    image.write_image(args.out, final, args.exposure, args.tonemap)


def _adaptive_main(args, config, scene, camera) -> int:
    """Band- or tile-granular adaptive render (models/adaptive.py): the
    budget is the uniform render's total sample count, spent where the
    variance estimate says it helps most."""
    from pathtracing_tpu_torch.models import adaptive

    granularity = args.adaptive_granularity
    if granularity == "tiles" and (
        config.height % args.adaptive_tile or
        config.width % args.adaptive_tile
    ):
        ptlog.log_warning(
            "adaptive: %dx%d not divisible by tile %d — falling back "
            "to band granularity", config.width, config.height,
            args.adaptive_tile,
        )
        granularity = "bands"

    if granularity == "tiles":
        return _adaptive_tiles_main(args, config, scene, camera)

    if args.target_rmse > 0.0:
        ptlog.log_warning(
            "--target-rmse is tile-granularity only; band-granular "
            "adaptive renders the full --spp budget"
        )
    band_rows = adaptive.pick_band_rows(config, args.adaptive_band_rows)
    n_bands = config.height // band_rows
    ptlog.log_information(
        "adaptive: %d bands of %d rows, %d bands/round",
        n_bands, band_rows,
        args.adaptive_k or max(1, n_bands // 8),
    )

    def progress(state, spent, budget):
        spp = state.band_spp.cpu().numpy()
        ptlog.log_information(
            "adaptive: %d/%d band-samples spent (band spp min %d / "
            "mean %.1f / max %d)", spent, budget, int(spp.min()),
            float(spp.mean()), int(spp.max()),
        )

    with metrics.Timer(scene.tri_v0.device) as t:
        state, rounds = adaptive.render_adaptive(
            scene, camera, config, band_rows=band_rows,
            bands_per_round=args.adaptive_k, progress=progress,
        )
        img = adaptive.resolve(state, band_rows)
    spp = state.band_spp.cpu().numpy()
    _write_final(args, config, scene, camera, img, int(spp.min()),
                 float(spp.mean()))
    ptlog.log_information(
        "wrote %s (adaptive: %d rounds in %.1fs; band spp min %d / "
        "mean %.1f / max %d)", args.out, rounds, t.seconds,
        int(spp.min()), float(spp.mean()), int(spp.max()),
    )
    return 0


def _adaptive_tiles_main(args, config, scene, camera) -> int:
    """Tile-granular adaptive render (the default): the greedy scheduler
    at 8x8-tile granularity, which follows 2D-compact noise that row
    bands smear across every column."""
    from pathtracing_tpu_torch.models import adaptive

    tile = adaptive.pick_tile(config, args.adaptive_tile)
    n_tiles = (config.height // tile) * (config.width // tile)
    ptlog.log_information(
        "adaptive: %d tiles of %dx%d, %d tiles/round",
        n_tiles, tile, tile, args.adaptive_k or max(1, n_tiles // 8),
    )

    def progress(state, spent, budget):
        spp = state.tile_spp.cpu().numpy()
        ptlog.log_information(
            "adaptive: %d/%d tile-samples spent (tile spp min %d / "
            "mean %.1f / max %d)", spent, budget, int(spp.min()),
            float(spp.mean()), int(spp.max()),
        )

    with metrics.Timer(scene.tri_v0.device) as t:
        state, rounds = adaptive.render_adaptive_tiles(
            scene, camera, config, tile=tile,
            tiles_per_round=args.adaptive_k, progress=progress,
            auto_uniform=args.adaptive_auto,
            target_rmse=args.target_rmse,
        )
        img = adaptive.resolve_tiles(state, config, tile)
    if args.target_rmse > 0.0:
        ptlog.log_information(
            "target-rmse %.4g: stopped at predicted RMSE %.4g",
            args.target_rmse,
            float(adaptive.predicted_rmse(state, config, tile)),
        )
    spp = state.tile_spp.cpu().numpy()
    _write_final(args, config, scene, camera, img, int(spp.min()),
                 float(spp.mean()))
    ptlog.log_information(
        "wrote %s (adaptive: %d rounds in %.1fs; tile spp min %d / "
        "mean %.1f / max %d)", args.out, rounds, t.seconds,
        int(spp.min()), float(spp.mean()), int(spp.max()),
    )
    return 0


def _tiled_main(args, config, scene, camera) -> int:
    """Band-tiled render: per-band completion tracking, resume and
    optional fault injection (utils/tiles.py), or per-band adaptive
    sampling."""
    from pathtracing_tpu_torch.utils import tiles

    def progress(band, spp):
        ptlog.log_information("band %d at %d spp", band, spp)

    if args.adaptive:
        state = tiles.render_tiled_adaptive(
            scene, camera, config, args.tiles, progress=progress
        )
        mean = _maybe_denoise(
            args, config, scene, camera, tiles.resolve_tiled(state),
            float(np.mean(state.band_spp)),
        )
        image.write_image(args.out, mean, args.exposure, args.tonemap)
        ptlog.log_information(
            "wrote %s (adaptive; band spp %s)", args.out,
            list(map(int, state.band_spp)),
        )
        return 0

    device = scene.tri_v0.device
    state = None
    if args.checkpoint and os.path.exists(args.checkpoint):
        try:
            state = tiles.load(args.checkpoint, config, args.tiles,
                               device=device)
        except ValueError as e:
            ptlog.log_critical("%s", e)
            return 2
        ptlog.log_information(
            "resumed tiled render: band spp %s",
            list(map(int, state.band_spp)),
        )

    state = tiles.render_tiled(
        scene, camera, config, args.tiles, state=state,
        checkpoint_path=args.checkpoint,
        inject_fault_band=args.inject_fault, progress=progress,
    )
    spp = int(state.band_spp.min())
    _write_final(args, config, scene, camera,
                 state.accum / float(max(spp, 1)), spp)
    ptlog.log_information(
        "wrote %s (%d bands x %d spp)", args.out, args.tiles, spp,
    )
    return 0


class _Preview:
    """Optional live preview window (the reference's swapchain present,
    `Renderer.cs:976-991`), disabled with a warning when matplotlib is
    missing."""

    def __init__(self) -> None:
        try:
            import matplotlib.pyplot as plt

            self._plt = plt
            plt.ion()
            self._fig, self._ax = plt.subplots()
            self._im = None
        except Exception:
            ptlog.log_warning("matplotlib unavailable; preview disabled")
            self._plt = None

    def update(self, linear, spp: int) -> None:
        if self._plt is None:
            return
        if not isinstance(linear, torch.Tensor):
            linear = torch.as_tensor(np.asarray(linear, np.float32))
        rgb = image.tonemap(linear).cpu().numpy()
        if self._im is None:
            self._im = self._ax.imshow(rgb)
        else:
            self._im.set_data(rgb)
        self._ax.set_title(f"{spp} spp")
        self._fig.canvas.draw_idle()
        self._plt.pause(0.001)


if __name__ == "__main__":
    sys.exit(main())
