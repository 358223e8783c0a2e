#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pathtracing_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. device  — the card's name and power limit; TF32 off.
  2. build   — compile the port's CUDA sources into the git-ignored build
               directory, one ``nvcc`` per source, all started together;
               print each kernel's registers, stack and spills
               (``ptxas -v``).
  3. kernels — each hand-written kernel against its plain torch version
               on the card:
               * the flat traversal pair on the flagship's own waves
                 (1920x1080 camera rays, one bounce wave, and the NEE
                 shadow waves of both), with every 11th lane dead and a
                 ray count that is not a multiple of the block size; then
                 on a random triangle soup of 1,863 clusters. Both walk
                 the set's cluster tree. The closest hit is held bit for
                 bit (t, slot, normal, mat) against its plain version
                 ``trace_flat_walk_torch`` and under the tie contract
                 against ``trace_torch`` (the JAX order); the any hit
                 equal to its plain version ``occluded_tree_torch`` and to
                 ``occluded_torch`` (the JAX order);
               * the instanced traversal pair on the same four waves of
                 instanced_demo, once static with material overrides, once
                 with a motion set (a second transform per instance) at
                 per-ray random shutter times, once with the motion set
                 and no time given (mid-shutter); then on 262,157 rays of
                 instanced_demo(grid=19), 5,777 expanded clusters in 362
                 placements, and of instanced_demo(grid=33,
                 subdivisions=0), 1,090 placements (two shared-memory
                 chunks of placement boxes). The closest hit is held bit
                 for bit (t, slot, normal, mat), the any hit equal;
               * the row gather against ``torch.index_select``, bit for
                 bit, for the many-light scene's (288, 24) packed table
                 and the 2,073,600 indices of a real light pick, and for
                 awkward shapes (one row, odd widths, one index, an
                 unaligned table, indices below 0 and past the table);
               * big scenes: cornell_mesh(8) (1.3 M triangles, 8 pages of
                 2,048 clusters), built through ``scenes.cornell_mesh``.
                 The paged walk's closest hit on its camera, bounce and
                 both shadow waves, and its any hit on both shadow waves;
                 the tree walks on the unpaged ClusterSet of the same
                 triangles (closest hit on the camera and bounce waves,
                 any hit on the shadow waves) and on the paged set
                 (per-page walk, pages nearest first, camera and bounce
                 waves); the paged closest hit and the per-page walk again
                 on the camera wave over the same triangles paged by 1,536
                 (10 pages). Each kernel runs and is timed on the whole
                 wave; it is held bit for bit against its plain version,
                 and under the tie contract against ``trace_torch`` (the
                 per-page walk also against the page-order walk
                 ``trace_tree_paged_torch``), on 65,549 rays drawn from
                 the wave (the plain versions synchronise with the host
                 once per cluster or walk step).
               * light transport waves: the flat any hit on envmap_demo's
                 environment-NEE shadow wave (toward t = 1e7) and on
                 spotlight_demo's delta-light shadow wave, both from the
                 scenes' own first bounce over the whole frame less 37
                 with every 11th lane dead; the flat closest hit on
                 sphere_demo's camera wave (a one-cluster flat set); the
                 gather on the 16,588,800 candidate indices of a real RIS
                 pick (M = 8) on many_lights_demo. Held as above, timed,
                 with their bounds.
               * surface attributes and cameras: the flat pair on
                 textured_demo's camera, bounce and bounce shadow waves,
                 screenlight_demo's camera shadow wave (toward its
                 textured screen) and the flagship's waves through the
                 equirect camera (rays over the whole sphere); the paged
                 pair on the bounce and bounce shadow waves of the
                 textured, smooth-shaded cornell_mesh(8)
                 (``scenes.textured_cornell_mesh_builder``), and its slot
                 map: the camera wave's ``Hit.prim`` through row 6 and
                 ``slot_to_tri`` against the "bvh" route's prim.
               * the wavefront and media waves: the flat pair on the
                 flagship's wavefront pool at its second iteration (2^20
                 slots of mixed depth) and its shadow wave, and on the
                 second bounce of fog_demo and smoke_demo (rays from fog
                 and grid collision points) with its shadow wave.
               * binning: rows 7-8 on the unpaged cornell_mesh(8)'s camera,
                 bounce and shadow waves as they come and sorted into
                 (cell, octant) bins: kernel ms both ways, the binning's
                 own ms, and the binned results mapped back equal to the
                 unbinned ones (the tie contract for the closest hit).
               * the instanced field (row 10): 64 x 64 placements of the
                 81,920-triangle icosphere (``ptbench.scenes.
                 instanced_field``), past the flat budget, so the two-level
                 walks: both kernels bit for bit against their plain walks
                 on a wave aimed at every placement and its shadow wave,
                 and on the field's 1080p camera, bounce and shadow waves
                 (the plain walks on 65,549 rays of each), timed with their
                 bounds, then a timed render of the field.
               * the counter-based generator (``csrc/rng.cu``, run first,
                 right after the build): every public entry of
                 ``ops/rng`` on the flagship's 1080p wave (every pixel id,
                 the sample index as an int and per lane, every LD stream,
                 ``n`` None to 25) bit for bit against its plain int64
                 version on the card, each kernel's ms (CUDA events) beside
                 its bytes over 3.35 TB/s; whether a fresh process finds
                 the library built (``cuda_build.compiled_here("rng")``,
                 False) and its load time; and the ``ptbench: set-up``
                 parts of a run of ``cornell_mesh6.progressive`` after the
                 build (a machine's second run).
               Each traversal kernel's bound counts the cluster
               evaluations its wave needs in any visiting order
               (``needed_evals``, a slab-test pass over the whole wave
               against the final t), so kernels of one query share it.
  4. renders — the flagship (cornell_mesh(6)), instanced_demo (gradient
               sky), many_lights_demo, cornell_mesh(8) (paged), the
               same triangles unpaged in a scene without pages (which
               routes to the tree walks), the nine scenes of the light
               transport (sphere_demo, veach_mis, checker_demo,
               glass_demo, frosted_demo, prism_demo, envmap_demo,
               principled_demo, spotlight_demo, each with its preferred
               background) and many_lights_demo with RIS (M = 8), each at
               1920x1080, depth 8, NEE with MIS, LD sampler, 1 spp per
               progressive step, seed 0: one warm-up step and 3 timed
               steps through ``progressive.render_step``, then
               ``resolve`` and one profiled step. Every kernel's launch
               count is set to 0 just before a scene's timed steps and
               read just after: the flagship must launch the flat pair,
               the instanced scene the instanced pair and no flat kernel,
               the many-light scene the gather, cornell_mesh(8) the paged
               pair (closest hit and any hit) and no flat kernel, the
               unpaged one (its rays binned, as ``RenderConfig.ray_sort``
               asks) both tree walks and neither the flat nor the paged
               kernels, the nine new scenes the flat pair and no
               other kernel, the RIS render the flat pair and the gather
               and no other. Then textured_demo, bump_demo,
               screenlight_demo, textured_demo with mips (``add_mips``)
               and the textured cornell_mesh(8), their profiled steps
               with the device time of ``surface_attributes`` and the
               texture lookups; the flagship through the ortho, fisheye
               and equirect projections and a moving camera (one timed
               step each); the flagship through the wavefront engine
               (pool 2^20; its segments equal the megakernel's, its image
               the megakernel's within ``WAVEFRONT_IMAGE_TOL``, two runs
               of one step equal bit for bit); fog_demo, smoke_demo,
               fire_demo and sss_demo through the megakernel (the grid
               scenes' profiles with the walks' device time) and
               smoke_demo through the wavefront engine (one timed step,
               against the megakernel's image of the same samples);
               ``render_reference`` at 1920x1080 against the
               CPU; and the "bvh" route (plain torch) on cornell_bsdf and
               textured_demo at 128x128, depth 4: its hits on the camera
               and first bounce waves against the cluster route's, its
               image within 1e-4 of theirs, no kernel launched.
     Then the schedulers, the post-passes and the file loaders: bands
               (8 rows) and tiles (8x8) with every unit picked each round
               for 2 rounds, and ``uniform_tile_rounds``, each equal bit
               for bit to ``progressive.render_step``'s sums of the same
               samples; rows 1-2 on the band scheduler's rows-mode wave
               (the 16 bands a greedy round picks, 245,760 rays) and the
               tile scheduler's pixels-mode wave (4,050 tiles packed
               tile-major, 259,200 rays), camera, bounce and both shadow
               waves, each ray at its unit's sample counter, held bit for
               bit against their plain versions and timed against their
               bounds, with each wave's launches; ``render_adaptive_tiles``
               and ``render_adaptive`` at a 4-spp budget (seconds, rounds,
               spp spent, image gate, rows 1-2 and no other kernel), one
               greedy tile round profiled, and a tile render with
               ``target_rmse`` (the 4-spp render's predicted RMSE, twice
               the budget: where it stops); all five AOVs of the flagship
               (uv and albedo also of textured_demo), finite in [0, 1];
               ``denoise_render`` and ``apply_bloom`` of the flagship's
               4-spp image (seconds, device ms and ops); a 3-frame
               ``temporal.advance`` orbit at 1 spp a frame (seconds a
               frame, share of pixels reusing history); each scene of
               ``examples/`` (five JSON files, two glb files) loaded on
               the card (host seconds) and rendered for one timed 1-spp
               step through the route its routing picks.
     Then the app shell and ``parallel/``, each phase with its seconds:
               ``render.main`` in-process on the flagship (``--scene
               cornell_mesh`` pointed at the built cornell_mesh(6)) at
               1920x1080, depth 8, ``--spp 6 --spp-per-step 1
               --checkpoint --snapshot-every 2 --metrics-jsonl
               --out-hdr``, interrupted (Ctrl-C) in its fifth step and
               resumed from its checkpoint: the resumed radiance equals
               six direct ``progressive.render_step`` calls bit for bit
               (a checkpoint's fingerprint covers ``--spp``, so the
               resume keeps the interrupted run's flags; another
               ``--seed`` is refused); the metrics log's seconds a step
               against the direct steps' (the shell's overhead) and the
               step that writes a snapshot against the others (the
               asynchronous present); ``--tiles 4 --inject-fault 1 --spp
               2`` equal to the 2-spp render bit for bit; the
               ``--adaptive``, ``--orbit 2 --temporal --denoise``, ``--aov
               normal`` and ``examples/cornell.json`` branches at 480x270
               and 1 spp. Every run launches rows 1-2 (the AOV row 1)
               and no other kernel. Then two sharded 1-spp steps at a
               world size of 1 over NCCL (``multihost_init`` from
               torchrun's variables) equal to ``progressive`` bit for
               bit, with ``gather_image``; ``render_adaptive_sharded``
               at a world size of 1 (budget 4, warmup 2) against
               ``render_adaptive_tiles`` with the same K and spp a
               round, bit for bit; and the layout simulation: every
               rank's ``rank_block`` of the (4, 1), (2, 2) and (1, 4)
               layouts on the one card, merged in rank order, against a
               4-spp progressive step, bit for bit with tiles only and
               within rtol 1e-6 / atol 1e-5 with a samples axis.
  5. check   — each image is finite with a plausible mean, and a small
               render of each scene through the kernels agrees with the
               same render through the plain versions: 64x64 for the
               earlier and the new scenes, cornell_mesh(3) through each
               camera, the textured cornell_mesh(3) paged by 16, an
               instanced field over a textured ground (rows 4-5) and
               cornell_mesh(3) paged by 16; 32x32 at depth 4 for the
               unpaged cornell_mesh(8); 64x64 for the media scenes; and
               through the wavefront pool, an instanced field with object
               motion (rows 4-5), many_lights_demo (row 3),
               cornell_mesh(3) paged by 16 (row 6) and sss_demo.
  6. bench   — ``python -m pathtracing_tpu_torch.bench`` in quick mode as
               a subprocess, with the megakernel and with
               ``BENCH_ENGINE=wavefront``; both JSON lines are required and
               printed.

It prints one JSON line per kernel result, a ``{"kernels": [...]}`` line
with all ten kernels, the card's name and power limit, and as its last
line ``{"ok": true, "device": {...}}``. It imports nothing of JAX. Without
a CUDA device, or without the package beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
START = time.perf_counter()

DEVICE = "cuda"
WIDTH, HEIGHT, DEPTH = 1920, 1080, 8
TIMED_STEPS = 3
PLAIN_CHUNK = 1 << 18        # rays per chunk of the flat plain versions
# The instanced plain versions pay one host round trip per expanded cluster
# and chunk, so they take the waves in larger pieces.
INST_PLAIN_CHUNK = 1 << 20
KERNEL_REPS = 10             # launches averaged per kernel timing
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
# and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Float operations of one Woop triangle test, counted from
# csrc/cluster_trace.cu: 3 components x 11 mul/add + clamp, negate,
# divide, 2 mul + 3 add for u, v, u+v, 5 compares and the running-min
# compare.
TRI_OPS = 48
CLUSTER_SIZE = 128
# Cluster-table bytes per cluster: AABB 24, Woop 4x384x4, normal 3x128x4,
# mat 128x4.
WOOP_BYTES, NORMAL_BYTES, MAT_BYTES, BOX_BYTES = 6144, 1536, 512, 24
# Float operations that take a ray into an instance's object space, counted
# from csrc/cluster_trace_inst.cu: to_object is 6 rows x 5 mul/add; with
# motion load_xform adds 12 lerps x 3, 9 cofactors x 3, the determinant 5,
# guard and divide 3, 9 scalings, the translation 3 x 6.
XFORM_OPS, MOTION_XFORM_OPS = 30, 30 + 36 + 27 + 5 + 3 + 9 + 18
# Bytes per expanded cluster: box 24, cmap 4, xform 48; imat 4 where the
# closest-hit kernel reads it; with motion fw0 and fw1 (96) replace xform.
EXP_BYTES, IMAT_BYTES, MOTION_EXTRA_BYTES = 76, 4, 48
GATHER_SHAPE = (288, 24, WIDTH * HEIGHT)   # (L, W, N) of the many-light pick
TPU_SOURCE = "pathtracing_tpu/ops/cluster_trace.py"
BIG_SUBDIVISIONS = 8         # cornell_mesh(8): 14,736 clusters, 8 pages
BIG_SUBSET = 65_549          # rays of a big-scene wave held against plain
FORCED_PAGE = 1536           # cornell_mesh(8) in 10 pages
# Tree-node bytes: box 24, meta 8, the 16 octant links 64.
NODE_BYTES = 96
# The scenes of the light-transport slice, rendered at full size, and the
# RIS candidate count of the many-light render through RIS.
NEW_SCENES = ("sphere_demo", "veach_mis", "checker_demo", "glass_demo",
              "frosted_demo", "prism_demo", "envmap_demo", "principled_demo",
              "spotlight_demo")
RIS_M = 8
# The surface-attribute scenes rendered at full size (with textured_demo
# again with mips, and the textured, smooth-shaded cornell_mesh(8)), the
# flagship's camera variants (the three other projections and a pinhole
# moving between CORNELL_CAMERA's pose and MOTION_POSITION), and the
# "bvh" route's renders: size, depth, scenes.
ATTR_SCENES = ("textured_demo", "bump_demo", "screenlight_demo")
CAMERA_CASES = ("ortho", "fisheye", "equirect", "motion")
MOTION_POSITION = (0.3, 0.2, 3.2)
BVH_SIZE, BVH_DEPTH = 128, 4
BVH_SCENES = ("cornell_bsdf", "textured_demo")
# Largest per-pixel difference between a "bvh" render and the cluster
# route's at BVH_SIZE², BVH_DEPTH, 2 spp: the port's CPU run measured
# 4.9e-5 (cornell_bsdf) and 3.5e-5 (textured_demo), as the two routes
# round t apart (Möller–Trumbore against the Woop test).
BVH_IMAGE_TOL = 1e-4
# The "bvh" route's t (Möller–Trumbore) against the cluster route's (the
# Woop test): within BVH_T_RTOL·t + BVH_T_ATOL. Bounce rays leave a
# surface at coordinates near 1, so short hits (t from 0.004) part by a
# few ulps of those coordinates: measured on the CPU and on the card at
# 128x128 (cornell_bsdf, textured_demo), up to 7.2e-7 absolute, 1e-5
# relative; 17 of 29,186 bounce rays beyond 4e-6 relative.
BVH_T_RTOL, BVH_T_ATOL = 4e-6, 2e-6
# render_reference on the card against the CPU, per pixel: 1,345,027 of
# the 2,073,600 pixels differ, by at most 4.12e-5 (this script on "NVIDIA
# H100 80GB HBM3, 700.00 W"): last-bit differences of the two devices'
# arithmetic, magnified where sqrt(disc) of the quadratic nears 0 at the
# sphere's silhouette.
REFERENCE_TOL = 1e-4
# Image means below 0.05 that are the scene's own: spotlight_demo is lit
# by three delta lights alone (the JAX package's CPU render of it has mean
# 0.0295 at 24x24, 3 spp, seed 0); the flagship seen through the equirect
# camera is mostly the black outside of the box (the port's CPU render at
# 64x36, 2 spp: mean 0.0241).
MIN_MEAN = {"spotlight_demo": 0.01, "flagship equirect": 0.01,
            "fire_demo": 0.005}
# fire_demo is lit by its emissive plume alone: the port's CPU render at
# 96x54, 4 spp, seed 0 has mean 0.0239, and this script's 1080p render
# 0.0221 on "NVIDIA H100 80GB HBM3, 700.00 W"; hence (0.005, 5).
# The media scenes (rendered at full size through the megakernel; smoke
# also through the wavefront engine), the wavefront pool, and the largest
# per-pixel difference allowed between a wavefront image and the
# megakernel's of the same samples: both engines compute each path's
# estimate with the same operations (equal on the CPU, bit for bit), so
# only the order of the image sums could part them.
MEDIA_SCENES = ("fog_demo", "smoke_demo", "fire_demo", "sss_demo")
VOLUME_SCENES = ("smoke_demo", "fire_demo")
WAVEFRONT_POOL = 1 << 20
WAVEFRONT_IMAGE_TOL = 1e-5
# The adaptive schedulers at 1080p with their defaults (models/adaptive.py):
# bands of 8 rows (135 bands, K = 135 // 8 = 16: 128 rows, a wave of
# 245,760 rays) and 8x8 tiles (32,400 tiles, K = 4,050: a wave of 259,200
# rays packed tile-major); budget 4 spp after a 2-spp warmup, 2 spp a
# picked tile a round. The target_rmse render gets twice the budget and,
# as its target, the 4-spp tile render's own predicted RMSE.
BAND_ROWS, TILE = 8, 8
ADAPTIVE_BUDGET, ADAPTIVE_WARMUP, TILE_SPP_PER_ROUND = 4, 2, 2
EQUAL_SPP = 2                # samples of the equal-spp identity renders
TEMPORAL_FRAMES = 3          # 1 spp a frame, 2 degrees of orbit a frame
BLOOM_STRENGTH = 0.3
# The repository's example scenes, each loaded on the card and rendered
# for one timed 1-spp 1080p step through the route its routing picks.
EXAMPLE_SCENES = ("cornell.json", "motion.json", "outdoor.json",
                  "showcase.json", "studio.json", "gltf_demo.glb",
                  "gltf_torture.glb")
# The launch counters of each traversal route (models/scene.cluster_route).
ROUTE_COUNTERS = {"flat": ("trace", "occluded"),
                  "instanced": ("trace_inst", "occluded_inst"),
                  "paged": ("trace_paged_dnf", "occluded_paged_dnf"),
                  "tree": ("trace_tree", "occluded_tree"),
                  "inst_tree": ("trace_inst_tree", "occluded_inst_tree")}
# The instanced field of the benchmark's generator
# (ptbench/scenes/instanced_field.py): 64 x 64 placements of the
# 81,920-triangle icosphere, whose static placements past the flat budget
# take the two-level walks (row 10); and the bytes of one placement's
# record: the transform 48, the root 4, the override 4, the world box 24.
FIELD = {"grid": 64, "subdivisions": 6, "radius": 0.45, "spacing": 1.5,
         "placement_seed": 7}
PLACEMENT_BYTES = 80
# Profiler ranges put around the attribute resolve and the texture lookups,
# or around the voxel-grid walks, for a profiled step (``profiler_ranges``).
RANGE_PREFIX = "ranges:"
# The design of the big-scene kernels on the shared walker
# (csrc/cluster_walk.cuh), and the plain versions they are held to bit for
# bit, named in the kernels line.
WALK_DESIGN = ("per-ray walk, one leaf held per lane, held leaves evaluated "
               "by the whole warp (cluster_walk.cuh warp_walk)")
DESIGNS = {
    "trace_paged_dnf": {"design": WALK_DESIGN + " over each page's tree, "
                        "pages nearest first; table normal and material",
                        "plain": "trace_paged_walk_torch"},
    "occluded_paged_dnf": {"design": WALK_DESIGN + " over each page's tree, "
                           "any hit", "plain": "occluded_paged_dnf_torch"},
    "trace_tree": {"design": WALK_DESIGN + " over the unpaged set's tree; "
                   "normal from the winner's Woop w-row",
                   "plain": "trace_tree_torch"},
    "occluded_tree": {"design": WALK_DESIGN + " over the unpaged set's "
                      "tree, any hit (any_hit_walk, row 2's body)",
                      "plain": "occluded_tree_torch"},
    "trace_tree_paged": {"design": WALK_DESIGN + " over each page's tree, "
                         "pages nearest first (row 6's walk); normal from "
                         "the winner's Woop w-row",
                         "plain": "trace_tree_paged_walk_torch",
                         "vs_trace_tree_paged_torch": "tie contract held"},
}


class SmokeFailure(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 1):
    """Mean time of ``fn`` over ``reps`` runs, from CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def in_chunks(fn, arrays, stats, chunk):
    """Run a plain traversal ``fn(*arrays, stats=...)`` over ``chunk``-ray
    pieces of the per-ray ``arrays``; sums the stats."""
    import torch

    outs = []
    n = arrays[0].shape[0]
    for s in range(0, n, chunk):
        st = {}
        outs.append(fn(*(a[s:s + chunk] for a in arrays), stats=st))
        for k, v in st.items():
            stats[k] = stats.get(k, 0) + v
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def kill_lanes(t):
    t = t.clone()
    t[::11] = 0.0
    return t


def make_waves(scene, camera, config, pix=None, bounce=True, sample=0):
    """A scene's first waves: camera rays, the bounce wave one shading
    step makes of them, and the NEE shadow wave of each (``bounce=False``:
    the camera wave and its shadow wave only). ``pix`` are the pixel ids
    (default: the whole frame less 37, so the ray count is not a multiple
    of the 128-ray block); ``sample`` the sample counter, one for the wave
    or one per ray (the adaptive schedulers' waves). Returns {name:
    (origin, direction, cap)} with every 11th lane dead."""
    import torch

    from pathtracing_tpu_torch.models import scene as scene_mod
    from pathtracing_tpu_torch.models import shading
    from pathtracing_tpu_torch.ops import lights, linalg, rng

    dev = scene.tri_v0.device
    if pix is None:
        pix = torch.arange(WIDTH * HEIGHT - 37, dtype=torch.int64,
                           device=dev)
    n = pix.shape[0]
    keys, o0, d0 = shading.camera_sample(camera, config, config.seed, pix,
                                         sample)
    big = torch.full((n,), 3.0e38, device=dev)
    all_live = torch.ones(n, dtype=torch.bool, device=dev)

    def shadow(o, d, active, depth):
        hit = scene_mod.intersect_batch(scene, o, d, "cluster_cuda",
                                        active=active)
        u = rng.uniform(rng.stream_key(keys, depth, rng.STREAM_NEE), 3)
        lp, _, _, _ = lights.sample_solid_angle(scene.lights, u,
                                                hit.position)
        wi_vec = lp - hit.position
        dist = torch.sqrt(torch.clamp(linalg.dot(wi_vec, wi_vec),
                                      min=1e-12))
        cap = torch.where(active & hit.valid, dist * (1.0 - 1e-3), 0.0)
        return hit.position, wi_vec / dist[:, None], kill_lanes(cap)

    waves = {
        "camera": (o0, d0, kill_lanes(big)),
        "camera_shadow": shadow(o0, d0, all_live, 0),
    }
    if bounce:
        out = shading.bounce_batch(
            scene, o0, d0, keys, 0, torch.zeros((n, 3), device=dev),
            torch.ones((n, 3), device=dev), all_live, config.rr_start_depth,
            config.background, "cluster_cuda", nee=True,
        )
        o1, d1, act1 = out[2], out[3], out[4]
        waves["bounce"] = (o1, d1, kill_lanes(torch.where(act1, big, 0.0)))
        waves["bounce_shadow"] = shadow(o1, d1, act1, 1)
    return waves


def light_waves(scene, camera, config):
    """The shadow waves of the light-transport branches from a scene's own
    first bounce at depth 0, as ``shading.bounce_batch`` draws them:
    ``env_shadow`` (environment NEE toward t = 1e7, scenes with ``env``)
    and ``delta_shadow`` (delta-light NEE, scenes with ``delta``), each
    from the camera hits of the whole frame less 37 with every 11th lane
    dead; the lanes ``bounce_batch`` would not trace get a zero cap.
    Returns {name: (origin, direction, cap)}."""
    import torch

    from pathtracing_tpu_torch.models import scene as scene_mod
    from pathtracing_tpu_torch.models import shading
    from pathtracing_tpu_torch.ops import envmap, lights, linalg, materials
    from pathtracing_tpu_torch.ops import rng

    dev = scene.tri_v0.device
    pix = torch.arange(WIDTH * HEIGHT - 37, dtype=torch.int64, device=dev)
    keys, o0, d0 = shading.camera_sample(camera, config, config.seed, pix, 0)
    hit = scene_mod.intersect_batch(scene, o0, d0, "cluster_cuda")
    mtype = materials.gather(scene.material_table, hit.mat_id)[0]
    lit = hit.valid & materials.is_nee_type(mtype)
    waves = {}
    if scene.env is not None:
        ue = rng.uniform(rng.stream_key(keys, 0, rng.STREAM_ENV), 2)
        wi, pdf = envmap.sample(scene.env, ue[:, 0], ue[:, 1])
        cand = lit & (linalg.dot(hit.normal, wi) > 1e-6) & (pdf > 1e-12)
        waves["env_shadow"] = (hit.position, wi, kill_lanes(
            torch.where(cand, shading.ENV_SHADOW_T, 0.0)))
    if scene.delta is not None:
        ud = rng.uniform(rng.stream_key(keys, 0, rng.STREAM_DELTA))
        wi, t_sh, _ = lights.sample_delta(scene.delta, ud, hit.position)
        cand = lit & (linalg.dot(hit.normal, wi) > 1e-6)
        waves["delta_shadow"] = (hit.position, wi,
                                 kill_lanes(torch.where(cand, t_sh, 0.0)))
    return waves


def ris_candidates(scene, camera, config, m):
    """The light-pick indices of a real RIS pick at depth 0: each camera
    hit's ``m`` candidates from the first ``3m`` NEE uniforms (candidate
    0's from the LD draw under the LD sampler), ``lights.pick`` of their
    first coordinate: (R·m,) int64."""
    import torch

    from pathtracing_tpu_torch.models import shading
    from pathtracing_tpu_torch.ops import lights, rng

    dev = scene.tri_v0.device
    pix = torch.arange(WIDTH * HEIGHT, dtype=torch.int64, device=dev)
    keys, _, _ = shading.camera_sample(camera, config, config.seed, pix, 0)
    uu = rng.uniform(rng.stream_key(keys, 0, rng.STREAM_NEE), 3 * m + 1)
    u0 = uu[:, :3 * m].reshape(-1, m, 3)[:, :, 0].clone()
    if config.sampler == "ld":
        u0[:, 0] = rng.ld_scalar(config.seed, pix, 0, rng.STREAM_NEE)
    return lights.pick(scene.lights, u0.reshape(-1))


def make_soup(n_tris=160_000, n_rays=(1 << 18) + 13, seed=0):
    """Random triangle soup (past 1024 clusters) and random rays from a
    seed, with every 11th lane dead: ClusterSet on the card and
    {"soup": closest-hit wave, "soup_shadow": any-hit wave}."""
    import numpy as np
    import torch

    from pathtracing_tpu_torch.ops import clusters as cluster_ops

    rs = np.random.RandomState(seed)
    v0 = (rs.rand(n_tris, 3) * 4.0 - 2.0).astype(np.float32)
    e1 = (rs.randn(n_tris, 3) * 0.05).astype(np.float32)
    e2 = (rs.randn(n_tris, 3) * 0.05).astype(np.float32)
    mat = rs.randint(0, 4, n_tris).astype(np.int32)
    cl, _, _ = cluster_ops.build_clusters(v0, e1, e2, mat)
    cl = cluster_ops.ClusterSet(*(torch.as_tensor(a, device=DEVICE)
                                  for a in cl))
    o = (rs.randn(n_rays, 3) * 0.5).astype(np.float32)
    d = rs.randn(n_rays, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    cap = (rs.rand(n_rays) * 2.0).astype(np.float32)
    o, d = torch.as_tensor(o, device=DEVICE), torch.as_tensor(d,
                                                               device=DEVICE)
    big = torch.full((n_rays,), 3.0e38, device=DEVICE)
    return cl, {
        "soup": (o, d, kill_lanes(big)),
        "soup_shadow": (o, d, kill_lanes(torch.as_tensor(cap,
                                                         device=DEVICE))),
    }


def make_motion_demo(seed=11, grid=12, subdivisions=3):
    """instanced_demo's field (``grid``² icospheres of ``subdivisions``)
    with a second, shutter-close transform per instance (a seeded turn
    about the vertical axis and a drift of up to 0.4 units), given to
    ``add_instances(motion_transforms=...)``."""
    import numpy as np

    from pathtracing_tpu_torch.models import scenes
    from pathtracing_tpu_torch.models.scene import SceneBuilder

    b = SceneBuilder()
    ground = b.lambertian((0.6, 0.58, 0.52))
    b.add_quad((-14.0, 0.0, -14.0), (28.0, 0.0, 0.0), (0.0, 0.0, 28.0),
               ground)
    light = b.emissive((40.0, 38.0, 34.0))
    b.add_quad((-2.0, 9.0, -6.0), (4.0, 0.0, 0.0), (0.0, 0.0, 4.0), light)
    mats = [b.lambertian((0.70, 0.30, 0.25)),
            b.metal((0.85, 0.85, 0.9), 0.08),
            b.ggx((0.9, 0.7, 0.35), roughness=0.25)]
    verts, faces = scenes.icosphere(subdivisions, 0.45)
    ts, overrides = scenes.instanced_field(grid, mats)
    rs = np.random.default_rng(seed)
    closes = []
    for m in ts:
        a = float(rs.uniform(-0.5, 0.5))
        c, s = np.cos(a), np.sin(a)
        turn = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        drift = rs.uniform(-0.4, 0.4, 3) * [1.0, 0.25, 1.0]
        closes.append(np.concatenate(
            [turn @ m[:, :3], (m[:, 3] + drift)[:, None]], axis=1))
    b.add_instances(verts, faces, mats[0], ts, materials=overrides,
                    motion_transforms=closes)
    return b.build(DEVICE)


def needed_evals(aabb_min, aabb_max, wave, t_final, occluded=None,
                 chunk_elems=1 << 25):
    """Cluster evaluations a wave needs, whatever order a kernel visits
    the boxes in: for each live ray of a closest-hit query, the boxes it
    pierces (the plain versions' slab test) before its final t
    (``t_final``, the query's result), and at least one for a ray that
    hit (the winner, whose box a flat wall's hit may touch only at t
    itself); for an any-hit query (``occluded``, its (R,) result), the
    boxes an unoccluded ray pierces before its cap and one for an
    occluded ray. Any visiting order must evaluate at least these, since a
    ray's best t never drops below its final t. ``aabb_min``/``aabb_max``:
    the real clusters' (C, 3) boxes (expanded clusters' world boxes for an
    instanced scene). Slab tests run in chunks of about ``chunk_elems``
    (ray, box) pairs."""
    import torch

    from pathtracing_tpu_torch.ops import cluster_trace as ct

    origin, direction, t_init = wave[:3]
    live = t_init > 0
    cap = t_final
    total = torch.zeros((), dtype=torch.int64, device=origin.device)
    if occluded is not None:
        total += (live & occluded).sum()
        live = live & ~occluded
        hit_ray = torch.zeros_like(live)
    else:
        hit_ray = live & (t_final < t_init)
    inv_d = ct._safe_inv(direction)
    step = max(1, chunk_elems // aabb_min.shape[0])
    for s in range(0, origin.shape[0], step):
        o, iv = origin[s:s + step], inv_d[s:s + step]
        tn = tf = None
        for ax in range(3):
            t0 = (aabb_min[:, ax] - o[:, ax, None]) * iv[:, ax, None]
            t1 = (aabb_max[:, ax] - o[:, ax, None]) * iv[:, ax, None]
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            tn = torch.clamp(lo, min=-3.0e38) if tn is None else (
                torch.maximum(tn, lo))
            tf = torch.clamp(hi, max=3.0e38) if tf is None else (
                torch.minimum(tf, hi))
        pierced = ((tn <= tf) & (tf > ct.T_MIN)
                   & (tn < cap[s:s + step, None]) & live[s:s + step, None])
        per_ray = pierced.sum(dim=1)
        total += torch.where(hit_ray[s:s + step],
                             torch.clamp(per_ray, min=1), per_ray).sum()
    return int(total)


def bound_ms(evals, n_rays, n_clusters, ray_bytes, n_exp=0, motion=False,
             table_bytes=None):
    """Least time for a wave: the Woop tests its rays need (``evals``,
    the (ray, cluster) pairs of ``needed_evals``, times the cluster's 128
    triangles, plus for an instanced scene the transform of the ray into
    that pair's object space) over the float32 peak, or its bytes (rays
    in, results out, the prototype cluster tables and the ``n_exp``
    expanded-cluster rows once, or ``table_bytes`` where given) over HBM
    bandwidth, whichever is larger. The slab tests of the kernel's box
    sweep or tree walk are a cost of that algorithm, not of the query,
    and stay out."""
    closest = ray_bytes > 33
    per_pair = CLUSTER_SIZE * TRI_OPS
    if n_exp:
        per_pair += MOTION_XFORM_OPS if motion else XFORM_OPS
    ops = evals * per_pair
    table = n_clusters * (WOOP_BYTES + (
        NORMAL_BYTES + MAT_BYTES if closest else 0))
    if n_exp:
        table += n_exp * (EXP_BYTES + (IMAT_BYTES if closest else 0)
                          + (MOTION_EXTRA_BYTES if motion else 0))
    else:
        table += n_clusters * BOX_BYTES
    if table_bytes is not None:
        table = table_bytes
    nbytes = n_rays * (ray_bytes + (4 if motion else 0)) + table
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), ops, nbytes


def held_rays(wave, sub):
    """The wave's per-ray arrays on the rays ``sub`` (all rays: None)."""
    return wave if sub is None else tuple(a[sub] for a in wave)


def check_trace(kernel, plain, wave, chunk=PLAIN_CHUNK, strict=False,
                normal_tol=1e-6, sub=None, reference=None, shadow=False,
                boxes=None, oracle=None):
    """A closest-hit kernel against its plain version on one wave.
    ``kernel(*wave)`` and ``plain(*wave, stats=...)`` take the wave's
    per-ray arrays (origin, direction, t_init[, time]). The kernel runs
    and is timed on the whole wave; the plain version runs on the rays
    ``sub`` of it (default all), where the two are compared. Default: the
    tie contract (t within rtol 1e-6 on live lanes, slot equal or t tied,
    normals within 1e-4 and materials equal where the slots agree).
    ``strict``: t, slot and material equal on every lane and normals
    within ``normal_tol`` (``normal_bit_diffs`` counts the rays whose
    normal is not bit-equal). ``reference(o, d, t)``: a second
    closest-hit function (``trace_torch``) that the kernel must meet under
    the tie contract on the same rays (``tie_mismatches``; ``shadow``:
    equal in ``slot >= 0`` too). ``oracle(o, d, t)``: a further
    closest-hit function held the same way (``oracle_tie_mismatches``).
    ``boxes``: (aabb_min, aabb_max) of the real clusters, to count the
    evaluations the wave needs (``needed_evals``, for the bound)."""
    import torch

    t0 = wave[2]
    kernel(*wave)                                # warm-up launch
    ms, out_k = cuda_ms(lambda: kernel(*wave), KERNEL_REPS)
    rays = held_rays(wave, sub)
    tk, sk, nk, mk = held_rays(out_k, sub)
    stats = {}
    plain_ms, (tp, sp, np_, mp) = cuda_ms(
        lambda: in_chunks(plain, rays, stats, chunk))
    live = rays[2] > 0
    n_err = (nk - np_).abs().amax(dim=1)
    if strict:
        hit = sp >= 0
        bad = (tk != tp) | (sk != sp) | (mk != mp) | (n_err > normal_tol)
    else:
        hit = (sk == sp) & live & (sp >= 0)
        bad = ~tie_ok((tp, sp, np_, mp), (tk, sk, nk, mk), live)
    err = torch.where(live, (tk - tp).abs(), 0.0)
    res = {
        "rays": int(t0.shape[0]), "live": int((t0 > 0).sum()),
        "hits": int((sp >= 0).sum()), "mismatches": int(bad.sum()),
        "max_abs_err": float(err.max()),
        "max_normal_err": float(torch.where(hit, n_err, 0.0).max()),
        "normal_bit_diffs": int((hit & (n_err > 0)).sum()),
        "ms": ms, "plain_ms": plain_ms, "stats": stats,
    }
    if sub is not None:
        res["plain_rays"] = int(sub.shape[0])
    if reference is not None:
        ref = reference(*rays)
        tie_bad = ~tie_ok(ref, (tk, sk, nk, mk), live)
        if shadow:
            tie_bad = tie_bad | ((sk >= 0) != (ref[1] >= 0))
        res["tie_mismatches"] = int(tie_bad.sum())
    if oracle is not None:
        res["oracle_tie_mismatches"] = int(
            (~tie_ok(oracle(*rays), (tk, sk, nk, mk), live)).sum())
    if boxes is not None:
        res["needed_evals"] = needed_evals(*boxes, wave, out_k[0])
    return res


def tie_ok(ref, new, live):
    """(R,) bool: where the closest-hit result ``new`` meets the tie
    contract against ``ref``: t within rtol 1e-6 on live lanes, slot equal
    or t tied, normals within 1e-4 and materials equal where the slots
    agree."""
    import torch

    (tr, sr, nr, mr), (tn, sn, nn, mn) = ref, new
    same_slot = sn == sr
    t_ok = torch.isclose(tn, tr, rtol=1e-6, atol=0.0) | ~live
    slot_ok = same_slot | (tn == tr) | ~live
    hit = same_slot & live & (sr >= 0)
    normal_ok = ((nn - nr).abs().amax(dim=1) <= 1e-4) | ~hit
    mat_ok = (mn == mr) | ~hit
    return t_ok & slot_ok & normal_ok & mat_ok


def check_occluded(kernel, plain, wave, chunk=PLAIN_CHUNK, sub=None,
                   reference=None, boxes=None):
    """An any-hit kernel against its plain version: occlusion equal on the
    rays ``sub`` (default all), and equal there to ``reference``'s result
    when given: a closest hit's ``slot >= 0`` (``trace_torch``) or an any
    hit's bool (``occluded_torch``). ``boxes`` as in ``check_trace``."""
    cap = wave[2]
    kernel(*wave)                                # warm-up launch
    ms, occ_k = cuda_ms(lambda: kernel(*wave), KERNEL_REPS)
    rays = held_rays(wave, sub)
    occ_held = occ_k if sub is None else occ_k[sub]
    stats = {}
    plain_ms, occ_p = cuda_ms(lambda: in_chunks(plain, rays, stats, chunk))
    bad = occ_held != occ_p
    res = {
        "rays": int(cap.shape[0]), "live": int((cap > 0).sum()),
        "occluded": int(occ_p.sum()), "mismatches": int(bad.sum()),
        "max_abs_err": float(bad.float().max()),
        "ms": ms, "plain_ms": plain_ms, "stats": stats,
    }
    if sub is not None:
        res["plain_rays"] = int(sub.shape[0])
    if reference is not None:
        ref = reference(*rays)
        ref_occ = ref[1] >= 0 if isinstance(ref, tuple) else ref
        res["tie_mismatches"] = int((occ_held != ref_occ).sum())
    if boxes is not None:
        res["needed_evals"] = needed_evals(*boxes, wave, cap,
                                           occluded=occ_k)
    return res


def flat_fns(clusters):
    """(closest-hit kernel, its plain version, any-hit kernel, its plain
    version, the index-order oracles ``trace_torch`` and ``occluded_torch``
    in ``PLAIN_CHUNK`` pieces) of a flat ClusterSet, as functions of a
    wave's arrays."""
    from pathtracing_tpu_torch.ops import cluster_trace as ct

    return (
        lambda o, d, t: ct.trace(clusters, o, d, t),
        lambda o, d, t, stats: ct.trace_flat_walk_torch(clusters, o, d, t,
                                                        stats=stats),
        lambda o, d, t: ct.occluded(clusters, o, d, t),
        lambda o, d, t, stats: ct.occluded_tree_torch(clusters, o, d, t,
                                                      stats=stats),
        lambda o, d, t: in_chunks(
            lambda *a, stats: ct.trace_torch(clusters, *a), (o, d, t), {},
            PLAIN_CHUNK),
        lambda o, d, t: in_chunks(
            lambda *a, stats: ct.occluded_torch(clusters, *a), (o, d, t), {},
            PLAIN_CHUNK),
    )


def inst_fns(clusters, inst):
    """As ``flat_fns`` for an instanced scene; a wave may carry a fourth
    array, the per-ray shutter time."""
    from pathtracing_tpu_torch.ops import cluster_trace as ct

    return (
        lambda o, d, t, tm=None: ct.trace_inst(clusters, inst, o, d, t,
                                               time=tm),
        lambda o, d, t, tm=None, stats=None: ct.trace_inst_torch(
            clusters, inst, o, d, t, time=tm, stats=stats),
        lambda o, d, t, tm=None: ct.occluded_inst(clusters, inst, o, d, t,
                                                  time=tm),
        lambda o, d, t, tm=None, stats=None: ct.occluded_inst_torch(
            clusters, inst, o, d, t, time=tm, stats=stats),
    )


def report(kname, res, failures, **extra):
    print(kname + " " + json.dumps({**extra, **{
        k: v for k, v in res.items() if k != "stats"}}), flush=True)
    if (res["mismatches"] or res.get("tie_mismatches")
            or res.get("oracle_tie_mismatches")):
        failures.append(f"{kname} {extra}: {res['mismatches']} rays "
                        f"against the plain version, "
                        f"{res.get('tie_mismatches', 0)} against the "
                        "JAX-order oracle, "
                        f"{res.get('oracle_tie_mismatches', 0)} against the "
                        "second oracle")


def check_gather(table, idx, label, failures, timed=False):
    """The gather kernel against ``torch.index_select`` on the clamped
    index, bit for bit. ``timed``: also the kernel's, the plain version's
    and the library call's times."""
    import torch

    from pathtracing_tpu_torch.ops import pgather

    out = pgather.gather_rows(table, idx)
    torch.cuda.synchronize()
    safe = torch.clamp(idx, 0, table.shape[0] - 1)
    ref = torch.index_select(table, 0, safe)
    bad = int((out.view(torch.int32) != ref.view(torch.int32)).sum())
    res = {"shape": [int(table.shape[0]), int(table.shape[1]),
                     int(idx.shape[0])],
           "idx_dtype": str(idx.dtype), "mismatches": bad,
           "max_abs_err": float((out - ref).abs().max()) if bad else 0.0}
    if timed:
        res["ms"], _ = cuda_ms(lambda: pgather.gather_rows(table, idx),
                               KERNEL_REPS)
        res["plain_ms"], _ = cuda_ms(
            lambda: pgather.gather_rows_torch(table, idx), KERNEL_REPS)
        res["library_ms"], _ = cuda_ms(
            lambda: torch.index_select(table, 0, safe), KERNEL_REPS)
        nbytes = (idx.numel() * idx.element_size() + out.numel() * 4
                  + table.numel() * 4)
        res["bytes"] = nbytes
        res["bound_ms"] = nbytes / PEAK_BYTES * 1e3
    print("gather_rows " + json.dumps({"case": label, **res}), flush=True)
    if bad:
        failures.append(f"gather_rows {label}: {bad} words")
    return res


def gather_checks(scene, config, failures):
    """The gather at the many-light pick's own shape and on awkward ones."""
    import torch

    from pathtracing_tpu_torch.ops import lights, rng

    lt = scene.lights
    n_rows, width, n = GATHER_SHAPE
    if tuple(lt.packed.shape) != (n_rows, width):
        raise SmokeFailure(f"packed light table {tuple(lt.packed.shape)}")
    pix = torch.arange(n, dtype=torch.int64, device=DEVICE)
    idx = lights.pick(lt, rng.ld_scalar(config.seed, pix, 0, rng.STREAM_NEE))
    if len(torch.unique(idx)) < n_rows // 2:
        raise SmokeFailure("the light pick reaches too few rows")
    main = check_gather(lt.packed, idx, "many_lights pick", failures,
                        timed=True)
    g = torch.Generator(device="cpu").manual_seed(5)

    def table(rows, w):
        return torch.randn((rows, w), generator=g).to(DEVICE)

    def index(rows, count, dtype=torch.int64):
        return torch.randint(-4, rows + 4, (count,), generator=g).to(
            device=DEVICE, dtype=dtype)

    check_gather(table(1, 24), index(1, 1000), "L=1", failures)
    check_gather(table(129, 3), index(129, 4099), "L=129 W=3", failures)
    check_gather(table(288, 24), index(288, 1), "N=1", failures)
    check_gather(table(288, 24), index(288, 70001, torch.int32),
                 "int32 indices", failures)
    check_gather(table(77, 5), index(77, 1 << 16), "W=5", failures)
    # W a multiple of 4 on a table that starts 4 bytes off a 16-byte
    # boundary: the kernel must leave its float4 path.
    off = torch.randn(300 * 24 + 1, generator=g).to(DEVICE)[1:].view(300, 24)
    check_gather(off, index(300, 5000), "unaligned table", failures)
    return main


def attribute_targets():
    """``surface_attributes`` and the texture lookups: the lookups inside
    ``surface_attributes`` (normal maps) count in both ranges."""
    from pathtracing_tpu_torch.models import scene as scene_mod
    from pathtracing_tpu_torch.ops import texture

    return ((scene_mod, "surface_attributes", "surface_attributes"),
            (texture, "sample_bilinear", "texture_lookups"),
            (texture, "sample_trilinear", "texture_lookups"))


def volume_targets():
    """The voxel grid's batched walks: free-flight sampling and the NEE
    arms' ratio-tracked transmittance."""
    from pathtracing_tpu_torch.ops import volume

    return ((volume, "sample_distance", "volume_walk"),
            (volume, "transmittance", "volume_walk"))


@contextlib.contextmanager
def profiler_ranges(targets):
    """Profiler ranges (``RANGE_PREFIX``) around the functions ``targets``
    ((module, name, label) triples), patched in for a profiled step only,
    so a profile can give their device time. A replayed CUDA graph calls
    none of them, so the step runs op by op (``megakernel._replays``)."""
    from torch.profiler import record_function

    from pathtracing_tpu_torch.models import megakernel

    saved = [(megakernel, "_replays", megakernel._replays)]
    megakernel._replays = lambda *args: False
    for mod, name, label in targets:
        orig = getattr(mod, name)

        def wrapped(*args, _orig=orig, _label=RANGE_PREFIX + label, **kw):
            with record_function(_label):
                return _orig(*args, **kw)

        saved.append((mod, name, orig))
        setattr(mod, name, wrapped)
    try:
        yield
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def profile_step(step, kernel_names, ranges=None):
    """Device time of one step by kernel, from torch.profiler: the share of
    each hand-written kernel in ``kernel_names``, the rest (plain torch:
    RNG, shading, sampling), and the device's busy share of the step's
    wall time. ``ranges``: ``profiler_ranges`` targets whose kernels'
    device time is also given, by label: the kernels launched by an op
    that starts inside a range's host interval.

    It reads the profiler's raw event list: ``prof.events()`` would build
    a Python event tree of every host op first, tens of seconds for a step
    of 10^5 device ops. Every device event but the hidden ones and the
    device-side range annotations is a device op, as ``prof.events()``
    counts them."""
    import bisect

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        if ranges:
            stack.enter_context(profiler_ranges(ranges))
        prof = stack.enter_context(profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    op_start = {}       # host op correlation id -> its start (ns)
    spans = []          # (start ns, end ns, label) of the host ranges
    launched = []       # (launching op's correlation id, device ms)
    for ev in prof.profiler.kineto_results.events():
        if ev.is_hidden_event():
            continue        # as prof.events() drops them
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            if name.startswith(RANGE_PREFIX):
                spans.append((ev.start_ns(), ev.end_ns(),
                              name[len(RANGE_PREFIX):] + "_ms"))
            elif ev.correlation_id():
                op_start.setdefault(ev.correlation_id(), ev.start_ns())
            continue
        if ev.device_type() != DeviceType.CUDA or name.startswith(
                RANGE_PREFIX):
            continue
        ms = ev.duration_ns() / 1e6
        by_name[name] = by_name.get(name, 0.0) + ms
        launched.append((ev.linked_correlation_id(), ms))
    if not by_name:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    in_ranges = {}
    for label in sorted({lb for _, _, lb in spans}):
        # The label's host intervals, merged; a launch counts once.
        merged = []
        for a, b in sorted((a, b) for a, b, lb in spans if lb == label):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        starts = [a for a, _ in merged]
        total = 0.0
        for cid, ms in launched:
            t = op_start.get(cid)
            i = -1 if t is None else bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= merged[i][1]:
                total += ms
        in_ranges[label] = total
    device_ms = sum(by_name.values())
    ours = {k: sum(v for n, v in by_name.items() if k in n)
            for k in kernel_names}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    if ranges and not any(in_ranges.values()):
        in_ranges = {"ranges": "not measured"}
    return {
        "wall_ms": wall_ms, "device_ms": device_ms,
        "busy_share": device_ms / wall_ms, "device_ops": len(launched),
        **{f"{k}_ms": v for k, v in ours.items()},
        "other_ms": device_ms - sum(ours.values()),
        **in_ranges,
        "top": [[n[:60], ms] for n, ms in top],
    }


def launch_counts():
    from pathtracing_tpu_torch.ops import cluster_trace as ct
    from pathtracing_tpu_torch.ops import pgather

    return {**ct.LAUNCHES, **pgather.LAUNCHES}


# Numbers of each timed render by label (``timed_render``).
RENDERS = {}


def step_fn(engine):
    """The progressive step of ``engine``: ``progressive.render_step``
    (megakernel) or ``wavefront.render_step``."""
    from pathtracing_tpu_torch.models import progressive, wavefront

    return {"megakernel": progressive.render_step,
            "wavefront": wavefront.render_step}[engine]


def timed_render(label, scene, camera, config, card, kernel_names,
                 min_mean=0.05, steps=TIMED_STEPS, ranges=None,
                 engine="megakernel"):
    """A warm-up step (and one taking stats on a state thrown away), then
    ``steps`` steps through the ``engine``'s ``render_step`` with every
    launch count set to 0 just before and read just after, ``resolve``,
    and one profiled step (``ranges``: with ``profiler_ranges`` of those
    targets). The image must be finite with a mean in (``min_mean``, 5).
    Returns (image, launches); the numbers go to ``RENDERS[label]`` (the
    wavefront's with its iterations and pool occupancy)."""
    import torch

    from pathtracing_tpu_torch.models import progressive

    step = step_fn(engine)
    state = progressive.init_state(config, device=DEVICE)
    t0 = time.perf_counter()
    state = step(state, scene, camera, config)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    # Steps that take stats are graphs of their own (``megakernel``):
    # capture them here, on a state thrown away (the image keeps its
    # samples), so the timed steps replay as the profiled one does.
    step(progressive.init_state(config, device=DEVICE), scene, camera,
         config, stats={})
    stats = {}
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state, scene, camera, config, stats=stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    image = progressive.resolve(state)
    segments = int(stats["segments"])
    shadow = int(stats["shadow_segments"])
    mrays = (segments + shadow) / dt / 1e6
    info = {
        "render": f"{label} {WIDTH}x{HEIGHT} depth{DEPTH} {engine} nee ld",
        "warmup_step_s": warm_s, "timed_steps": steps,
        "step_s": dt / steps, "segments": segments,
        "shadow_segments": shadow, "mrays_per_s": mrays,
        "launches": launches, "card": card,
    }
    if engine == "wavefront":
        from pathtracing_tpu_torch.models import wavefront

        info.update(pool=wavefront.pool_size(config),
                    iterations=stats["iterations"],
                    iterations_per_step=stats["iterations"] / steps,
                    pool_occupancy=segments / stats["slots"])
    print(json.dumps(info), flush=True)
    print(f"{label}: {mrays:.4f} Mrays/s ({segments + shadow} segments in "
          f"{dt:.3f} s) on {card}", flush=True)
    prof = profile_step(lambda: step(state, scene, camera, config),
                        kernel_names, ranges=ranges)
    print(f"profile {label} " + json.dumps(prof), flush=True)
    RENDERS[label] = {**info, "profile": prof}
    mean = image_gate(label, image, min_mean)
    print(f"{label}: image mean {mean:.6f}", flush=True)
    return image, launches


def check_routes(label, launches, used, optional=()):
    """Fail unless every kernel in ``used`` was launched and no other
    (``optional`` ones may be)."""
    for name, n in launches.items():
        if name in optional:
            continue
        if name in used and n <= 0:
            raise SmokeFailure(f"the {label} render launched no {name} "
                               "kernel")
        if name not in used and n != 0:
            raise SmokeFailure(f"the {label} render launched the {name} "
                               "kernel")


def small_render_check(label, scene, plain_scene, cam_cfg, background,
                       size=64, depth=DEPTH, nee_candidates=1,
                       engine="megakernel"):
    """A ``size``² render at ``depth`` (2 spp) through the kernels against
    the same render through the plain versions (``plain_scene`` with
    ``traversal="cluster_torch"``). Both routes compute the same t bit for
    bit (--fmad=false), so only a tie resolved to another triangle can
    part two paths. A ``cam_cfg`` with a shutter-close pose renders
    through its motion pair. ``engine="wavefront"``: both renders through
    the wavefront pool (one 2-spp step). Returns the kernel launches of
    the render through the kernels (the counts set to 0 just before
    it)."""
    from pathtracing_tpu_torch.models import progressive
    from pathtracing_tpu_torch.ops.camera import build_camera
    from pathtracing_tpu_torch.utils.config import RenderConfig

    pair = cam_cfg.motion_pair()
    cam = (build_camera(cam_cfg, 1.0, device=DEVICE) if pair is None else
           tuple(build_camera(c, 1.0, device=DEVICE) for c in pair))
    imgs = []
    launches = None
    for trav, sc in (("cluster_cuda", scene), ("cluster_torch", plain_scene)):
        cfg = RenderConfig(width=size, height=size, samples_per_pixel=2,
                           max_depth=depth, seed=0, traversal=trav,
                           background=background,
                           nee_candidates=nee_candidates)
        reset_launches()
        if engine == "wavefront":
            cfg = dataclasses.replace(cfg, samples_per_step=2)
            state = step_fn(engine)(progressive.init_state(cfg, DEVICE), sc,
                                    cam, cfg)
            imgs.append(progressive.resolve(state))
        else:
            imgs.append(progressive.render_once(sc, cam, cfg))
        if launches is None:
            launches = launch_counts()
    diff = (imgs[0] - imgs[1]).abs().amax(-1)
    frac = float((diff > 1e-4).float().mean())
    print(f"small render {label} {size}x{size} depth{depth} {engine} "
          "kernels vs "
          f"plain: max |diff| {float(diff.max()):.3e}, pixels over 1e-4: "
          f"{frac:.4%}", flush=True)
    if frac > 0.005:
        raise SmokeFailure(f"small render of {label} through the kernels "
                           "disagrees with the plain versions")
    return launches


def bench_check(engine="megakernel"):
    """``python -m pathtracing_tpu_torch.bench`` in quick mode
    (``BENCH_QUICK=1``) with ``BENCH_ENGINE=engine``, as a subprocess: its
    last line must be the JSON object with ``metric``, ``value``, ``unit``
    and ``vs_baseline`` null, the metric naming the engine."""
    t = phase(f"bench {engine}")
    env = dict(os.environ, BENCH_QUICK="1", BENCH_ENGINE=engine)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-m", "pathtracing_tpu_torch.bench"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    if out.returncode != 0:
        raise SmokeFailure(f"the bench module exited {out.returncode}: "
                           f"{out.stderr[-2000:]}")
    lines = out.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError) as e:
        raise SmokeFailure(f"the bench module printed no JSON line: {e}; "
                           f"{out.stdout[-2000:]}") from e
    if (set(line) != {"metric", "value", "unit", "vs_baseline"}
            or line["vs_baseline"] is not None or not line["value"] > 0
            or engine not in line["metric"]):
        raise SmokeFailure(f"the bench module's line is malformed: {line}")
    print(f"bench quick run ({engine}): {time.perf_counter() - t:.2f} s",
          flush=True)
    return line


RNG_SEED = 2**33 + 5          # high 32 bits set
RNG_SAMPLE = 17
RNG_NS = (None, 1, 2, 3, 25)


def _bit_equal(a, b):
    """Whether two results (tensors or tuples of them) hold the same
    bits, dtype and shape."""
    import torch

    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(_bit_equal, a, b))
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def _nbytes(*xs):
    import torch

    return sum(_nbytes(*x) if isinstance(x, tuple) else x.nbytes
               for x in xs if isinstance(x, tuple) or torch.is_tensor(x))


def rng_setup_run():
    """The ``ptbench: set-up`` line and the library's state in processes
    started after the build: one that loads ``csrc/rng.cu``'s library
    (``compiled_here``, the load's ms), and a run of
    ``cornell_mesh6.progressive`` (its window ends at the check's 128-spp
    snapshot)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    code = ("import json, time\n"
            "from pathtracing_tpu_torch.ops import cuda_build, rng\n"
            "t = time.perf_counter()\n"
            "cuda_build.load('rng', rng._SIGNATURES)\n"
            "print(json.dumps({'compiled_here': "
            "cuda_build.compiled_here('rng'), 'load_ms': "
            "(time.perf_counter() - t) * 1e3}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise SmokeFailure(f"loading the rng library failed: {out.stderr}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    if res["compiled_here"]:
        raise SmokeFailure("a process started after the build compiled "
                           "csrc/rng.cu again")
    run = subprocess.run(
        [sys.executable, "-m", "ptbench.run", "--workload",
         "cornell_mesh6.progressive", "--seed", str(RNG_SEED), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    setup = [ln for ln in run.stderr.splitlines()
             if ln.startswith("ptbench: set-up")]
    if run.returncode != 0 or not setup:
        raise SmokeFailure(f"ptbench exited {run.returncode}: "
                           f"{run.stderr[-2000:]}")
    line = json.loads(run.stdout.strip().splitlines()[-1])
    res["ptbench_setup"] = setup[-1]
    res["ptbench_setup_s"] = line["metrics"]["setup_s"]["value"]
    res["ptbench_correct"] = line["correct"]
    if not line["correct"]:
        raise SmokeFailure(f"ptbench's check failed: {line['compared']}")
    return res


def rng_checks():
    """Every public entry of ``ops/rng`` on the flagship's 1080p wave:
    its kernel (CUDA tensors) against its plain int64 version on the same
    tensors, bit for bit, timed (CUDA events) beside its bytes over
    3.35 TB/s; then ``rng_setup_run``."""
    import torch

    from pathtracing_tpu_torch.ops import rng

    t = phase("kernels vs plain: rng")
    pix = torch.arange(WIDTH * HEIGHT, device=DEVICE)
    gen = torch.Generator(device="cpu").manual_seed(7)
    lane_sample = torch.randint(0, 2**31, pix.shape, generator=gen).to(
        DEVICE)
    keys = rng.pixel_sample_key_torch(RNG_SEED, pix, RNG_SAMPLE)
    cases = [("key", (RNG_SEED, DEVICE)),
             ("pixel_sample_key", (RNG_SEED, pix, RNG_SAMPLE)),
             ("pixel_sample_key", (RNG_SEED, pix, lane_sample)),
             ("fold_in", (keys, 3)), ("fold_in", (keys, -(2**31))),
             ("fold_in", (keys[:1], pix)), ("fold_in", (keys, lane_sample)),
             ("stream_key", (keys, 2, rng.STREAM_NEE))]
    cases += [(name, (keys, n)) for name in ("random_bits", "uniform")
              for n in RNG_NS]
    cases += [(name, (RNG_SEED, pix, smp, tag))
              for name, bases in (("ld_pair", rng._LD_PAIR_BASES),
                                  ("ld_scalar", rng._LD_SCALAR_BASES))
              for tag in sorted(bases) for smp in (RNG_SAMPLE, lane_sample)]
    rows, bad = [], []
    for name, args in cases:
        kernel, plain = getattr(rng, name), getattr(rng, name + "_torch")
        out = kernel(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        equal = _bit_equal(out, ref)
        ms, _ = cuda_ms(lambda: kernel(*args), reps=KERNEL_REPS)
        plain_ms, _ = cuda_ms(lambda: plain(*args))
        nbytes = _nbytes(*args, out)
        label = {"args": [a if not torch.is_tensor(a) else
                         f"tensor{tuple(a.shape)}" for a in args[1:]]}
        rows.append({"entry": name, **label, "equal": equal,
                     "kernel_ms": ms, "bytes": nbytes,
                     "bound_ms": nbytes / PEAK_BYTES * 1e3,
                     "plain_ms": plain_ms})
        print("rng " + json.dumps(rows[-1]), flush=True)
        if not equal:
            bad.append(f"{name} {label}")
    if bad:
        raise SmokeFailure("rng kernels against their plain version: "
                           + "; ".join(bad))
    setup = rng_setup_run()
    print("rng setup " + json.dumps(setup), flush=True)
    print(f"rng checks: {len(rows)} cases equal "
          f"({time.perf_counter() - t:.2f} s)", flush=True)
    return {"cases": rows, "setup": setup}


def phase(name):
    now = time.perf_counter()
    print(f"== {name} (at {now - START:.1f} s)", flush=True)
    return now


def demangled_kernel(mangled):
    """The ``*_kernel`` name in a mangled symbol, with ``<true>`` or
    ``<false>`` for a kernel templated on one bool. Each name is read by
    its length prefix: the anonymous namespace's hash may end in digits
    that run into the kernel name's length."""
    import re

    pos = 0
    while m := re.compile(r"(\d+)[A-Za-z_]").search(mangled, pos):
        start, pos = m.end(1), m.end(1) + int(m.group(1))
        name = mangled[start:pos]
        if name.endswith("_kernel"):
            flag = {"ILb1E": "<true>", "ILb0E": "<false>"}
            return name + flag.get(mangled[pos:pos + 5], "")
    return mangled


def ptxas_report(names):
    """{kernel: {"registers", "stack_bytes", "spill_stores", "spill_loads",
    "log"}} from the ``ptxas -v`` output of each built source (template
    kernels as ``name<true>`` / ``name<false>``); ``log`` says whether this
    run compiled the library or read the log of a cached build."""
    import re

    from pathtracing_tpu_torch.ops import cuda_build

    out = {}
    for src in names:
        kernel = None
        log = ("compiled in this run" if cuda_build.compiled_here(src)
               else "cached build")
        for line in cuda_build.build_log(src).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = demangled_kernel(m.group(1))
                out[kernel] = {"log": log}
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and kernel:
                out[kernel].update(stack_bytes=int(m.group(1)),
                                   spill_stores=int(m.group(2)),
                                   spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                out[kernel]["registers"] = int(m.group(1))
    return out


def kernel_entry(name, kernel, source, replaces, launches, waves, main,
                 bound_of, library_ms=None, **extra):
    """One entry of the ``kernels`` line. ``waves``: {wave: result of a
    check}; ``main``: the wave whose numbers stand at the top level;
    ``bound_of(result)`` -> (bound_ms, bound_by, ops, bytes); ``extra``
    keys join the entry. Each wave also gives the evaluations it needs and
    the plain version's own slab tests and evaluations (on its held
    rays)."""
    per_wave = {}
    for w, r in waves.items():
        wb, wby, _, _ = bound_of(r)
        per_wave[w] = {"ms": r["ms"], "plain_ms": r["plain_ms"],
                       "bound_ms": wb, "bound_by": wby,
                       "mismatches": r["mismatches"], "rays": r["rays"],
                       **{k: r[k] for k in ("tie_mismatches", "plain_rays")
                          if k in r},
                       "needed_evals": r["needed_evals"],
                       **{"plain_" + k: v for k, v in r["stats"].items()}}
    b_ms, b_by, ops, nbytes = bound_of(waves[main])
    return {
        "name": name, "route": "cuda", "source": source, "kernel": kernel,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in waves.values()),
        "ms": waves[main]["ms"], "plain_ms": waves[main]["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        "wave": main, "ops": ops, "bytes": nbytes,
        "needed_evals": waves[main]["needed_evals"],
        "vs_plain": "agree", "waves": per_wave, **extra,
    }


def to_device(table):
    """A numpy NamedTuple of tables (ClusterSet, PageSet) on the card."""
    import torch

    return type(table)(*(None if a is None else torch.as_tensor(a,
                                                                device=DEVICE)
                         for a in table))


def big_scene_checks(camera, config, failures):
    """Phase 3's big-scene part (see the module docstring). Returns {"scene":
    the paged cornell_mesh(8), "flat": its unpaged ClusterSet on the card,
    "results": {kernel: {wave: check}}, and the table sizes}."""
    import torch

    from pathtracing_tpu_torch.models import scenes
    from pathtracing_tpu_torch.ops import cluster_trace as ct
    from pathtracing_tpu_torch.ops import clusters as cluster_ops

    t = phase("kernels vs plain: big scenes")
    scene, _ = scenes.cornell_mesh(BIG_SUBDIVISIONS, device=DEVICE)
    cl, pages = scene.clusters, scene.pages
    n_pages, page_size, n_real = ct.page_shape(cl, pages)
    n_real = int(n_real.sum())
    page_nodes = int(pages.node_box.shape[2])
    print(f"cornell_mesh({BIG_SUBDIVISIONS}): {scene.tri_v0.shape[0]} "
          f"triangles, {n_real} clusters in {n_pages} pages of {page_size} "
          f"({cl.woop.shape[0]} with padding), page trees of {page_nodes} "
          f"nodes; built in {time.perf_counter() - t:.2f} s", flush=True)
    if pages is None or n_pages != 8:
        raise SmokeFailure(f"cornell_mesh({BIG_SUBDIVISIONS}) is not paged "
                           "in 8 pages")
    t = time.perf_counter()
    host = [getattr(scene, f).cpu().numpy()
            for f in ("tri_v0", "tri_e1", "tri_e2", "tri_mat")]
    flat_np = cluster_ops.build_clusters(*host)[0]
    forced_np = cluster_ops.build_pages(flat_np, FORCED_PAGE)
    flat, (forced, forced_pages) = to_device(flat_np), (
        to_device(forced_np[0]), to_device(forced_np[1]))
    n_flat = int(flat.woop.shape[0])
    n_nodes = int(flat.node_box.shape[1])
    print(f"unpaged set of the same triangles: {n_flat} clusters, a tree of "
          f"{n_nodes} nodes; paged by {FORCED_PAGE}: "
          f"{forced_pages.node_box.shape[0]} pages "
          f"({time.perf_counter() - t:.2f} s)", flush=True)

    waves = make_waves(scene, camera, config)
    n_wave = waves["camera"][0].shape[0]
    gen = torch.Generator(device="cpu").manual_seed(8)
    sub = torch.randperm(n_wave, generator=gen)[:BIG_SUBSET].sort().values
    sub = sub.to(DEVICE)
    boxes = (flat.aabb_min, flat.aabb_max)
    refs, needed = {}, {}

    def reference(tables, key):
        def ref(o, d, cap):
            if key not in refs:
                refs[key] = ct.trace_torch(tables, o, d, cap)
            return refs[key]
        return ref

    results = {k: {} for k in ("trace_paged_dnf", "occluded_paged_dnf",
                               "trace_tree", "occluded_tree",
                               "trace_tree_paged")}

    def run_check(name, kernel, plain, tables, key, wname, oracle=None,
                  **extra):
        """Row ``name`` on wave ``wname``: bit for bit against its plain
        version and under the tie contract against ``trace_torch`` over
        ``tables`` (and ``oracle``, a closest hit, when given) on the rays
        ``sub``. The evaluations a wave needs are counted once for each
        query on it: every closest-hit kernel finds the same final t, so
        rows 6, 7 and 9 share one bound."""
        any_hit = name.startswith("occluded")
        count = (wname, any_hit)
        kw = dict(chunk=BIG_SUBSET, sub=sub, reference=reference(tables, key),
                  boxes=None if count in needed else boxes)
        if any_hit:
            res = check_occluded(kernel, plain, waves[wname], **kw)
        else:
            res = check_trace(kernel, plain, waves[wname], strict=True,
                              normal_tol=0.0, shadow="shadow" in wname,
                              oracle=oracle, **kw)
        res["needed_evals"] = needed.setdefault(count, res.get(
            "needed_evals"))
        results[name][wname if not extra else f"{wname}:{key}"] = res
        report(name, res, failures, wave=wname, **extra)

    def paged(c, p):
        return (lambda o, d, cap: ct.trace_paged_dnf(c, p, o, d, cap),
                lambda o, d, cap, stats: ct.trace_paged_walk_torch(
                    c, p, o, d, cap, stats=stats))

    def tree_paged(c, p):
        """Row 9 over ``(c, p)``: its kernel, its plain version (the
        nearest-first walk) and the page-order walk as a second oracle."""
        return dict(
            kernel=lambda o, d, cap: ct.trace_tree_paged(c, p, o, d, cap),
            plain=lambda o, d, cap, stats: ct.trace_tree_paged_walk_torch(
                c, p, o, d, cap, stats=stats),
            oracle=lambda o, d, cap: in_chunks(
                lambda *a, stats: ct.trace_tree_paged_torch(c, p, *a),
                (o, d, cap), {}, BIG_SUBSET))

    for wname in ("camera", "bounce", "camera_shadow", "bounce_shadow"):
        run_check("trace_paged_dnf", *paged(cl, pages), cl, "paged:" + wname,
                  wname)
    for wname in ("camera_shadow", "bounce_shadow"):
        run_check("occluded_paged_dnf",
                  lambda o, d, cap: ct.occluded_paged_dnf(cl, pages, o, d,
                                                          cap),
                  lambda o, d, cap, stats: ct.occluded_paged_dnf_torch(
                      cl, pages, o, d, cap, stats=stats),
                  cl, "paged:" + wname, wname)
    for wname in ("camera", "bounce"):
        run_check("trace_tree", lambda o, d, cap: ct.trace_tree(flat, o, d,
                                                                cap),
                  lambda o, d, cap, stats: ct.trace_tree_torch(
                      flat, o, d, cap, stats=stats),
                  flat, "flat:" + wname, wname)
        run_check("trace_tree_paged", tables=cl, key="paged:" + wname,
                  wname=wname, **tree_paged(cl, pages))
    for wname in ("camera_shadow", "bounce_shadow"):
        run_check("occluded_tree",
                  lambda o, d, cap: ct.occluded_tree(flat, o, d, cap),
                  lambda o, d, cap, stats: ct.occluded_tree_torch(
                      flat, o, d, cap, stats=stats),
                  flat, "flat:" + wname, wname)
    run_check("trace_paged_dnf", *paged(forced, forced_pages), forced,
              f"forced{FORCED_PAGE}", "camera", page_clusters=FORCED_PAGE)
    run_check("trace_tree_paged", tables=forced, key=f"forced{FORCED_PAGE}",
              wname="camera", page_clusters=FORCED_PAGE,
              **tree_paged(forced, forced_pages))
    del waves, refs, forced, forced_pages
    return {"scene": scene, "flat": flat, "results": results,
            "n_real": n_real, "n_pages": n_pages, "page_nodes": page_nodes,
            "n_flat": n_flat, "n_nodes": n_nodes}


def field_checks(card, failures):
    """Row 10 on the instanced field (``FIELD``, built through
    ``ptbench.scenes.instanced_field`` as the benchmark builds a scene):
    both two-level kernels bit for bit against their plain walks on a wave
    aimed at every placement (one camera ray to each placement's centre and
    that ray's shadow ray to the light's centre) and on the field's
    1080p waves (camera, bounce and both shadow waves; the plain walks on
    ``BIG_SUBSET`` rays of each); each kernel's ms, its bound (the
    prototype clusters its rays need, counted by the plain walk capped at
    the final t on the held rays and scaled to the wave's live rays) and
    its launches a step in a timed render. Returns the row's entries."""
    import numpy as np
    import torch

    from pathtracing_tpu_torch.ops import cluster_trace as ct
    from pathtracing_tpu_torch.ops.camera import build_camera
    from pathtracing_tpu_torch.utils.config import CameraConfig, RenderConfig
    from ptbench.scenes import instanced_field

    t = phase("kernels vs plain: the instanced field")
    data = instanced_field.scene_data(FIELD)
    scene = instanced_field.build_port(data, DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    cl, it = scene.clusters, scene.inst_tree
    if it is None:
        raise SmokeFailure("the instanced field did not take the two-level "
                           "route")
    n_place, n_clusters = int(it.xform.shape[0]), int(cl.woop.shape[0])
    n_nodes = int(it.node_box.shape[1] + it.forest_box.shape[1])
    print(f"instanced field: {n_place} placements (the base geometry's "
          f"first), {n_clusters} clusters stored, {n_nodes} tree nodes; "
          f"built in {build_s:.3f} s", flush=True)
    camera = build_camera(CameraConfig(**data["camera"]), WIDTH / HEIGHT,
                          device=DEVICE)
    config = RenderConfig(width=WIDTH, height=HEIGHT,
                          samples_per_pixel=TIMED_STEPS + 1, max_depth=DEPTH,
                          samples_per_step=1, seed=0, engine="megakernel",
                          nee=True, sampler="ld", background="black")

    def tk(o, d, cap):
        return ct.trace_inst_tree(cl, it, o, d, cap)

    def ok(o, d, cap):
        return ct.occluded_inst_tree(cl, it, o, d, cap)

    def tp(o, d, cap, stats):
        return ct.trace_inst_tree_torch(cl, it, o, d, cap, stats=stats)

    def op(o, d, cap, stats):
        return ct.occluded_inst_tree_torch(cl, it, o, d, cap, stats=stats)

    def needed(wave, t_final, occluded=None):
        """Prototype-cluster evaluations of the wave's held rays that any
        visiting order needs (the plain walk with best t fixed at the
        final t, or the cap of an unoccluded shadow ray, and one for an
        occluded one), scaled to the wave's live rays."""
        o, d, cap = wave[:3]
        live = cap > 0
        if occluded is not None:
            fixed = torch.where(occluded, 0.0, cap)
        else:
            fixed = torch.where(live, t_final, 0.0)
        stats = {}
        ct.trace_inst_tree_torch(cl, it, o, d, fixed, stats=stats)
        n = stats["cluster_evals"]
        if occluded is not None:
            n += int(occluded.sum())
        return n

    results = {"trace_inst_tree": {}, "occluded_inst_tree": {}}
    # Every placement's wave.
    eye = torch.tensor(data["camera"]["position"], dtype=torch.float32)
    centres = torch.tensor(np.array([m[:, 3] for m, _ in
                                     data["placements"]]),
                           dtype=torch.float32)
    d = centres - eye
    d = (d / torch.linalg.norm(d, dim=1, keepdim=True)).to(DEVICE)
    o = eye.expand_as(d).contiguous().to(DEVICE)
    wave = (o, d, torch.full((o.shape[0],), 3.0e38, device=DEVICE))
    res = check_trace(tk, tp, wave, strict=True, normal_tol=0.0,
                      chunk=o.shape[0])
    t_hit = tk(*wave)[0]
    res["needed_evals"] = needed(wave, t_hit)
    pos = o + t_hit[:, None] * d
    own = ((pos >= it.aabb_min[1:]) & (pos <= it.aabb_max[1:])).all(dim=1)
    res["own_placement_hits"] = int(own.sum())
    results["trace_inst_tree"]["placements"] = res
    report("trace_inst_tree", res, failures, wave="placements")
    corner, eu, ev, _ = data["quads"][1]
    light = torch.tensor(np.asarray(corner) + 0.5 * (np.asarray(eu)
                                                     + np.asarray(ev)),
                         dtype=torch.float32, device=DEVICE)
    wi = light - pos
    dist = torch.linalg.norm(wi, dim=1)
    shadow = (pos, wi / dist[:, None],
              torch.where(t_hit < 1e37, dist * (1.0 - 1e-3), 0.0))
    res = check_occluded(ok, op, shadow, chunk=o.shape[0])
    res["needed_evals"] = needed(shadow, None, ok(*shadow))
    results["occluded_inst_tree"]["placements_shadow"] = res
    report("occluded_inst_tree", res, failures, wave="placements_shadow")
    # The field's 1080p waves.
    waves = make_waves(scene, camera, config)
    n_wave = waves["camera"][0].shape[0]
    gen = torch.Generator(device="cpu").manual_seed(10)
    sub = torch.randperm(n_wave, generator=gen)[:BIG_SUBSET].sort().values
    sub = sub.to(DEVICE)
    for wname, wave in waves.items():
        held = held_rays(wave, sub)
        scale = float((wave[2] > 0).sum()) / max(float((held[2] > 0).sum()),
                                                 1.0)
        if wname.endswith("shadow"):
            name = "occluded_inst_tree"
            res = check_occluded(ok, op, wave, chunk=BIG_SUBSET, sub=sub)
            res["needed_evals"] = round(needed(held, None,
                                               ok(*held)) * scale)
        else:
            name = "trace_inst_tree"
            res = check_trace(tk, tp, wave, strict=True, normal_tol=0.0,
                              chunk=BIG_SUBSET, sub=sub)
            res["needed_evals"] = round(needed(held, tk(*held)[0]) * scale)
        results[name][wname] = res
        report(name, res, failures, wave=wname)
    del waves
    _, launches = timed_render("instanced_field64", scene, camera, config,
                               card, ("trace_inst_tree_kernel",
                                      "occluded_inst_tree_kernel"))
    check_routes("instanced_field64", launches, ROUTE_COUNTERS["inst_tree"])
    # The query's tables: the clusters' Woop rows (with normal and
    # material for the closest hit), the placement records and the nodes
    # of both levels; the trees are the walk's cost, but without them the
    # placements cannot be found.
    entries = []
    for name, main, ray_bytes, per_cluster in (
            ("trace_inst_tree", "bounce", 52,
             WOOP_BYTES + NORMAL_BYTES + MAT_BYTES),
            ("occluded_inst_tree", "bounce_shadow", 29, WOOP_BYTES)):
        table = (n_clusters * per_cluster + n_place * PLACEMENT_BYTES
                 + n_nodes * NODE_BYTES)
        entries.append(kernel_entry(
            name, name + "_kernel",
            "pathtracing_tpu_torch/csrc/cluster_trace_inst_tree.cu",
            "none (the JAX package expands every placement)",
            launches[name] / TIMED_STEPS, results[name], main,
            lambda r, rb=ray_bytes, tb=table: bound_ms(
                r["needed_evals"], r["rays"], n_clusters, rb,
                table_bytes=tb),
            plain_rays=BIG_SUBSET, build_s=build_s,
            design="two-level walk on the shared walker "
                   "(cluster_walk.cuh warp_walk, TwoLevel policy)",
            plain=name + "_torch"))
    return entries


def big_entries(big, big_launches, tree_launches, paged_by_scene):
    """The ``kernels`` entries of rows 6-9 of the port table (row 6 as its
    closest hit and its any hit, with its launches in each paged scene's
    render, ``paged_by_scene``)."""
    src = "pathtracing_tpu_torch/csrc/"
    res = big["results"]
    n_real, n_flat = big["n_real"], big["n_flat"]
    paged_nodes = big["n_pages"] * big["page_nodes"]
    # Row 6 keeps the query's own tables (a box, the Woop rows and, for the
    # closest hit, normal and material per real cluster), as rows 1-5 do:
    # its page trees are the walk's cost, not the query's.
    rows = (
        ("trace_paged_dnf", "cluster_trace_paged.cu", 2516,
         big_launches["trace_paged_dnf"], "camera", 52, None,
         f"cornell_mesh({BIG_SUBDIVISIONS}) render, closest hit"),
        ("occluded_paged_dnf", "cluster_trace_paged.cu", 2516,
         big_launches["occluded_paged_dnf"], "camera_shadow", 29, None,
         f"cornell_mesh({BIG_SUBDIVISIONS}) render, shadow rays (the JAX "
         "package answers them with its closest-hit page sweep)"),
        ("trace_tree", "cluster_trace_tree.cu", 2002,
         tree_launches["trace_tree"], "camera", 52,
         n_flat * (WOOP_BYTES + MAT_BYTES) + big["n_nodes"] * NODE_BYTES,
         f"cornell_mesh({BIG_SUBDIVISIONS}) unpaged, tree-route render"),
        ("occluded_tree", "cluster_trace_tree.cu", 1915,
         tree_launches["occluded_tree"], "camera_shadow", 29,
         n_flat * WOOP_BYTES + big["n_nodes"] * NODE_BYTES,
         f"cornell_mesh({BIG_SUBDIVISIONS}) unpaged, tree-route render"),
        ("trace_tree_paged", "cluster_trace_tree.cu", 2401, 0, "camera", 52,
         n_real * (WOOP_BYTES + MAT_BYTES) + paged_nodes * NODE_BYTES,
         "none: no caller in the JAX package's models (direct calls only)"),
    )
    entries = []
    for name, source, line, launches, main, ray_bytes, table, path in rows:
        entries.append(kernel_entry(
            name, name + "_kernel", src + source, f"{TPU_SOURCE}:{line}",
            launches, res[name], main,
            lambda r, rb=ray_bytes, tb=table: bound_ms(
                r["needed_evals"], r["rays"], n_real, rb, table_bytes=tb),
            path=path, plain_rays=res[name][main]["plain_rays"],
            vs_trace_torch="tie contract held", **DESIGNS.get(name, {}),
            **({"launches_by_scene": paged_by_scene[name]}
               if name in paged_by_scene else {})))
    return entries


def attribute_wave_checks(attr, attr_cams, flagship, flag_cam_cfg, config,
                          results, failures):
    """Rows 1-2 on the waves of the surface-attribute and camera slice,
    each against its plain version bit for bit and the JAX-order oracle:
    textured_demo's camera and bounce waves (their hits feed the attribute
    gather by slot; the bounce wave leaves along the shading normals) and
    its bounce shadow wave; screenlight_demo's camera shadow wave toward
    its textured screen (the points of ``sample_solid_angle(with_uv=
    True)``); and the flagship's waves through the equirect camera, whose
    rays cover the whole sphere. Whole frames less 37, every 11th lane
    dead. Adds to ``results`` under "scene:wave"."""
    from pathtracing_tpu_torch.ops.camera import build_camera

    phase("kernels vs plain: surface attributes and cameras")
    equirect = build_camera(dataclasses.replace(flag_cam_cfg,
                                                projection="equirect"),
                            WIDTH / HEIGHT, device=DEVICE)
    plan = (
        ("textured_demo", attr["textured_demo"][0],
         attr_cams["textured_demo"], ("camera", "bounce"),
         ("bounce_shadow",)),
        ("screenlight_demo", attr["screenlight_demo"][0],
         attr_cams["screenlight_demo"], (), ("camera_shadow",)),
        ("flagship equirect", flagship, equirect, ("camera",),
         ("camera_shadow",)),
    )
    for label, sc, cam, traced, shadowed in plan:
        tk, tp, ok, op, oracle, occ_oracle = flat_fns(sc.clusters)
        boxes = (sc.clusters.aabb_min, sc.clusters.aabb_max)
        waves = make_waves(sc, cam, config, bounce="bounce" in traced
                           or "bounce_shadow" in shadowed)
        for wname in traced:
            res = check_trace(tk, tp, waves[wname], strict=True,
                              normal_tol=0.0, reference=oracle, boxes=boxes)
            res["n_clusters"] = int(sc.clusters.woop.shape[0])
            results["trace"][f"{label}:{wname}"] = res
            report("trace_dnf", res, failures, wave=wname, scene=label)
        for wname in shadowed:
            res = check_occluded(ok, op, waves[wname], reference=occ_oracle,
                                 boxes=boxes)
            res["n_clusters"] = int(sc.clusters.woop.shape[0])
            results["occluded"][f"{label}:{wname}"] = res
            report("occluded_dnf", res, failures, wave=wname, scene=label)
        del waves


def textured_big_checks(camera, config, failures):
    """Row 6 on the textured, smooth-shaded cornell_mesh(8)
    (``scenes.textured_cornell_mesh_builder``, paged by
    ``SceneBuilder.build``): the closest hit on its bounce and bounce
    shadow waves (the shading normals turn the bounce wave) and the any
    hit on the bounce shadow wave, held bit for bit against the plain
    walks and under the tie contract against ``trace_torch`` on
    BIG_SUBSET rays; then the slot map: the camera wave's ``Hit.prim``
    through row 6 and ``slot_to_tri`` against the "bvh" route's prim on
    the same rays (prims equal where t is not tied). Returns {"scene",
    "results", "n_real"}."""
    import torch

    from pathtracing_tpu_torch.models import scene as scene_mod
    from pathtracing_tpu_torch.models import scenes
    from pathtracing_tpu_torch.ops import cluster_trace as ct

    t = phase("kernels vs plain: textured big scene")
    scene = scenes.textured_cornell_mesh_builder(BIG_SUBDIVISIONS).build(
        DEVICE)
    cl, pages = scene.clusters, scene.pages
    real = (cl.aabb_min <= cl.aabb_max).all(dim=1)
    n_real = int(real.sum())
    print(f"textured cornell_mesh({BIG_SUBDIVISIONS}): "
          f"{scene.tri_v0.shape[0]} triangles, {n_real} clusters in "
          f"{pages.node_box.shape[0]} pages; attr_pack "
          f"{tuple(scene.attr_pack.shape)} "
          f"({scene.attr_pack.numel() * 4 / 1e6:.1f} MB); built in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    if scene.attr_shn is None or scene.textures is None:
        raise SmokeFailure("the textured big scene lost its attributes")
    boxes = (cl.aabb_min[real], cl.aabb_max[real])
    waves = make_waves(scene, camera, config)
    gen = torch.Generator(device="cpu").manual_seed(8)
    sub = torch.randperm(waves["camera"][0].shape[0],
                         generator=gen)[:BIG_SUBSET].sort().values.to(DEVICE)

    def reference(o, d, cap):
        return ct.trace_torch(cl, o, d, cap)

    results = {"trace_paged_dnf": {}, "occluded_paged_dnf": {}}
    for wname in ("bounce", "bounce_shadow"):
        res = check_trace(
            lambda o, d, cap: ct.trace_paged_dnf(cl, pages, o, d, cap),
            lambda o, d, cap, stats: ct.trace_paged_walk_torch(
                cl, pages, o, d, cap, stats=stats),
            waves[wname], chunk=BIG_SUBSET, strict=True, normal_tol=0.0,
            sub=sub, reference=reference, shadow="shadow" in wname,
            boxes=boxes)
        results["trace_paged_dnf"]["textured:" + wname] = res
        report("trace_paged_dnf", res, failures, wave=wname,
               scene="textured cornell_mesh(8)")
    res = check_occluded(
        lambda o, d, cap: ct.occluded_paged_dnf(cl, pages, o, d, cap),
        lambda o, d, cap, stats: ct.occluded_paged_dnf_torch(
            cl, pages, o, d, cap, stats=stats),
        waves["bounce_shadow"], chunk=BIG_SUBSET, sub=sub,
        reference=reference, boxes=boxes)
    results["occluded_paged_dnf"]["textured:bounce_shadow"] = res
    report("occluded_paged_dnf", res, failures, wave="bounce_shadow",
           scene="textured cornell_mesh(8)")

    o, d, cap = held_rays(waves["camera"], sub)
    live = cap > 0
    hk = scene_mod.intersect_batch(scene, o, d, "cluster_cuda", active=live)
    bvh_ms, hb = cuda_ms(lambda: scene_mod.intersect_batch(scene, o, d,
                                                           "bvh"))
    tied = (hk.t - hb.t).abs() <= BVH_T_RTOL * hb.t + BVH_T_ATOL
    bad = live & ((hk.valid != hb.valid)
                  | (hk.valid & (hk.prim != hb.prim) & ~tied))
    n_live = int(live.sum())
    print("slot map " + json.dumps({
        "scene": f"textured cornell_mesh({BIG_SUBDIVISIONS})",
        "wave": "camera", "rays": n_live,
        "hits": int((live & hk.valid).sum()),
        "prim_mismatches": int(bad.sum()),
        "prims_differing": int((live & hk.valid
                                & (hk.prim != hb.prim)).sum()),
        "bvh_route_ms": bvh_ms}), flush=True)
    # A wrong slot map misses nearly every ray; allow only the rays that
    # graze an edge where the two triangle tests part.
    if int(bad.sum()) > 1e-4 * n_live or int((live & (hk.prim >= 0)).sum()
                                             ) < n_live // 4:
        raise SmokeFailure("the paged slot map does not resolve the kernel's "
                           "slots to the BVH route's triangles")
    del waves
    return {"scene": scene, "results": results, "n_real": n_real}


def attr_instanced_scene():
    """instanced_demo's field (6 x 6 of a subdivision-2 icosphere) over a
    grid-textured ground with quad uvs: an instanced scene whose base
    geometry carries attributes (prototype slots resolve to -1)."""
    from pathtracing_tpu_torch.models import scenes
    from pathtracing_tpu_torch.models.scene import SceneBuilder

    b = SceneBuilder()
    ground = b.lambertian((0.6, 0.58, 0.52),
                          texture=scenes.grid_texture(64, 8))
    b.add_quad((-14.0, 0.0, -14.0), (28.0, 0.0, 0.0), (0.0, 0.0, 28.0),
               ground, uv=True)
    light = b.emissive((40.0, 38.0, 34.0))
    b.add_quad((-2.0, 9.0, -6.0), (4.0, 0.0, 0.0), (0.0, 0.0, 4.0), light)
    mats = [b.lambertian((0.70, 0.30, 0.25)), b.metal((0.85, 0.85, 0.9), 0.08),
            b.ggx((0.9, 0.7, 0.35), roughness=0.25)]
    verts, faces = scenes.icosphere(2, 0.45)
    ts, overrides = scenes.instanced_field(6, mats)
    b.add_instances(verts, faces, mats[0], ts, materials=overrides)
    return b.build(DEVICE)


def camera_variant(cam_cfg, case):
    """The flagship's camera config for ``case``: a projection, or a
    pinhole moving to MOTION_POSITION over the shutter."""
    if case == "motion":
        return dataclasses.replace(cam_cfg, motion_position=MOTION_POSITION)
    return dataclasses.replace(cam_cfg, projection=case)


def build_pose(cam_cfg, aspect):
    """A camera, or the motion pair of a config with a shutter-close
    pose, on the card."""
    from pathtracing_tpu_torch.ops.camera import build_camera

    pair = cam_cfg.motion_pair()
    if pair is None:
        return build_camera(cam_cfg, aspect, device=DEVICE)
    return tuple(build_camera(c, aspect, device=DEVICE) for c in pair)


def reference_check():
    """``render_reference`` at 1920x1080 on the card against the same call
    on the CPU, per pixel within REFERENCE_TOL; returns its line."""
    import torch

    from pathtracing_tpu_torch.models.reference import render_reference

    ms, img = cuda_ms(lambda: render_reference(HEIGHT, WIDTH, device=DEVICE))
    ref = render_reference(HEIGHT, WIDTH, device="cpu")
    diff = (img.cpu() - ref).abs().amax(-1)
    err = float(diff.max())
    res = {"image": f"render_reference {WIDTH}x{HEIGHT}", "ms": ms,
           "max_abs_err_vs_cpu": err,
           "pixels_differing": int((diff > 0).sum()),
           "pixels_over_1e-6": int((diff > 1e-6).sum()),
           "pixels_over_1e-5": int((diff > 1e-5).sum()),
           "tolerance": REFERENCE_TOL}
    print("reference " + json.dumps(res), flush=True)
    if tuple(img.shape) != (HEIGHT, WIDTH, 4) or not bool(
            torch.isfinite(img).all()) or err > REFERENCE_TOL:
        raise SmokeFailure(f"the reference image disagrees with the CPU: "
                           f"{res}")
    return res


def bvh_checks(failures):
    """The "bvh" route on the card (plain torch, ``ops.bvh.traverse``) for
    BVH_SCENES at BVH_SIZE², against the cluster_cuda route: the camera
    and first bounce waves' hits (valid and triangle flags equal; t within
    BVH_T_RTOL·t + BVH_T_ATOL; prims through ``slot_to_tri`` equal where
    the scene has it, else materials equal) and a BVH_DEPTH, 2 spp
    image within BVH_IMAGE_TOL per pixel. The "bvh" render launches no
    kernel. Returns {scene: line}."""
    import torch

    from pathtracing_tpu_torch.models import progressive, scenes
    from pathtracing_tpu_torch.models import scene as scene_mod
    from pathtracing_tpu_torch.ops import cluster_trace as ct
    from pathtracing_tpu_torch.ops import pgather
    from pathtracing_tpu_torch.ops.camera import build_camera
    from pathtracing_tpu_torch.utils.config import RenderConfig

    phase("bvh route")
    out = {}
    for name in BVH_SCENES:
        sc, cc = scenes.get_scene(name, device=DEVICE)
        cam = build_camera(cc, 1.0, device=DEVICE)
        base = dict(width=BVH_SIZE, height=BVH_SIZE, samples_per_pixel=2,
                    max_depth=BVH_DEPTH, seed=0,
                    background=scenes.preferred_background(name))
        pix = torch.arange(BVH_SIZE * BVH_SIZE, device=DEVICE)
        waves = make_waves(sc, cam, RenderConfig(**base), pix=pix)
        line = {"scene": name, "size": BVH_SIZE, "depth": BVH_DEPTH,
                "bvh_nodes": int(sc.bvh.node_meta.shape[0])}
        for wname in ("camera", "bounce"):
            o, d, cap = waves[wname]
            live = cap > 0
            hc = scene_mod.intersect_batch(sc, o, d, "cluster_cuda",
                                           active=live)
            ms, hb = cuda_ms(lambda: scene_mod.intersect_batch(sc, o, d,
                                                               "bvh"))
            both = live & hc.valid
            tied = (hc.t - hb.t).abs() <= BVH_T_RTOL * hb.t + BVH_T_ATOL
            bad = live & ((hc.valid != hb.valid) | (hc.tri != hb.tri))
            bad |= both & ~tied
            if sc.slot_to_tri is not None:
                bad |= both & (hc.prim != hb.prim)
            else:
                bad |= both & (hc.mat_id != hb.mat_id)
            line[wname] = {"rays": int(live.sum()), "hits": int(both.sum()),
                           "mismatches": int(bad.sum()), "bvh_ms": ms,
                           "prim": ("through slot_to_tri"
                                    if sc.slot_to_tri is not None
                                    else "no slot map: materials")}
            if int(bad.sum()):
                failures.append(f"bvh route {name} {wname}: {int(bad.sum())} "
                                "rays against the cluster route")
        imgs = []
        for trav in ("cluster_cuda", "bvh"):
            ct.reset_launches()
            pgather.reset_launches()
            t0 = time.perf_counter()
            imgs.append(progressive.render_once(
                sc, cam, RenderConfig(traversal=trav, **base)))
            torch.cuda.synchronize()
            line[f"{trav}_render_s"] = time.perf_counter() - t0
        launched = {k: v for k, v in launch_counts().items() if v}
        diff = (imgs[0] - imgs[1]).abs().amax(-1)
        line.update(max_abs_err=float(diff.max()), tolerance=BVH_IMAGE_TOL,
                    bvh_render_launches=launched,
                    mean=float(imgs[1].mean()))
        print("bvh " + json.dumps(line), flush=True)
        if launched:
            failures.append(f"the bvh render of {name} launched {launched}")
        if not bool(torch.isfinite(imgs[1]).all()) or (
                line["max_abs_err"] > BVH_IMAGE_TOL):
            failures.append(f"the bvh render of {name} disagrees with the "
                            f"cluster route: {line['max_abs_err']}")
        out[name] = line
    return out


class _Captured(Exception):
    """Ends a render once ``capture_waves`` holds its waves."""


def capture_waves(step, call=1):
    """The waves the flat pair's kernel wrappers receive at their
    ``call``-th launch (0-based) inside ``step()``: {"bounce": (origin,
    direction, t_init), "shadow": (origin, direction, cap)}. The render is
    cut there. Launches made here are not the main path's (every timed
    render sets the counts to 0 first)."""
    from pathtracing_tpu_torch.models import scene as scene_mod

    saved = {q: scene_mod._ROUTES[q, "flat"] for q in ("trace", "occluded")}
    seen = {"trace": 0, "occluded": 0}
    waves = {}

    def recorder(query, kernel):
        def record(clusters, o, d, t):
            if seen[query] == call:
                waves[{"trace": "bounce", "occluded": "shadow"}[query]] = (
                    o.clone(), d.clone(), t.clone())
                if len(waves) == 2:
                    raise _Captured
            seen[query] += 1
            return kernel(clusters, o, d, t)
        return record

    for q, (plain, kernel) in saved.items():
        scene_mod._ROUTES[q, "flat"] = (plain, recorder(q, kernel))
    try:
        step()
    except _Captured:
        pass
    finally:
        scene_mod._ROUTES.update({(q, "flat"): v for q, v in saved.items()})
    if len(waves) != 2:
        raise SmokeFailure(f"captured {sorted(waves)} of the two waves")
    return waves


def new_flat_waves(scene, camera, config, media, results, failures):
    """Rows 1-2 on the waves of this slice, each against its plain
    version bit for bit and the JAX-order oracle: the wavefront pool's
    second iteration on the flagship (2^20 slots of mixed depth, fresh
    camera rays beside bounce rays) and its shadow wave, and the second
    bounce of fog_demo and smoke_demo through the megakernel, whose rays
    start at fog and grid collision points as well as at surfaces, with
    the shadow rays that leave those points. Adds to ``results`` under
    "scene:wave"."""
    import torch

    from pathtracing_tpu_torch.models import progressive

    phase("kernels vs plain: wavefront pool and media waves")
    pool_cfg = dataclasses.replace(config, wavefront_pool=WAVEFRONT_POOL)
    cases = [("wavefront pool", scene, camera, pool_cfg, "wavefront")]
    for name in ("fog_demo", "smoke_demo"):
        sc, cam, cfg, _ = media[name]
        cases.append((name, sc, cam, cfg, "megakernel"))
    gen = torch.Generator(device="cpu").manual_seed(10)
    for label, sc, cam, cfg, engine in cases:
        waves = capture_waves(lambda: step_fn(engine)(
            progressive.init_state(cfg, DEVICE), sc, cam, cfg))
        tk, tp, ok, op, oracle, occ_oracle = flat_fns(sc.clusters)
        boxes = (sc.clusters.aabb_min, sc.clusters.aabb_max)
        n_cl = int(sc.clusters.woop.shape[0])
        # The plain versions and the oracles take BIG_SUBSET rays of a wave
        # over many clusters (the kernel runs on the whole wave).
        n = waves["bounce"][0].shape[0]
        sub = (torch.randperm(n, generator=gen)[:BIG_SUBSET].sort().values
               .to(DEVICE) if n_cl > 64 else None)
        for key, wname, check in (
                ("trace", "bounce", lambda w: check_trace(
                    tk, tp, w, strict=True, normal_tol=0.0, sub=sub,
                    reference=oracle, boxes=boxes)),
                ("occluded", "shadow", lambda w: check_occluded(
                    ok, op, w, sub=sub, reference=occ_oracle,
                    boxes=boxes))):
            wave = waves[wname]
            res = check(wave)
            res["n_clusters"] = n_cl
            results[key][f"{label}:{wname}"] = res
            report(f"{key}_dnf", res, failures, wave=wname, scene=label)
        del waves
        torch.cuda.empty_cache()


def media_scenes():
    """{name: (scene, camera, config, camera config)} of the media scenes
    at full size, each with its preferred background."""
    from pathtracing_tpu_torch.models import scenes
    from pathtracing_tpu_torch.ops.camera import build_camera
    from pathtracing_tpu_torch.utils.config import RenderConfig

    out = {}
    for name in MEDIA_SCENES:
        sc, cc = scenes.get_scene(name, device=DEVICE)
        out[name] = (sc, build_camera(cc, WIDTH / HEIGHT, device=DEVICE),
                     RenderConfig(width=WIDTH, height=HEIGHT,
                                  samples_per_pixel=TIMED_STEPS + 1,
                                  max_depth=DEPTH, samples_per_step=1, seed=0,
                                  background=scenes.preferred_background(
                                      name)), cc)
    return out


def wavefront_flagship(scene, camera, config, card, flat_names, flat_routes,
                       flag_label, flag_img):
    """The flagship through the wavefront engine (pool 2^20), timed like
    the megakernel's render: its segment count must equal the
    megakernel's ``stats`` for the same steps, its image the megakernel's
    within ``WAVEFRONT_IMAGE_TOL``, and a second run of one step the
    first bit for bit. Returns its numbers."""
    import torch

    label = "flagship wavefront"
    cfg = dataclasses.replace(config, engine="wavefront",
                              wavefront_pool=WAVEFRONT_POOL)
    img, la = timed_render(label, scene, camera, cfg, card, flat_names,
                           engine="wavefront")
    check_routes(label, la, flat_routes)
    mine, mega = RENDERS[label], RENDERS[flag_label]
    for key in ("segments", "shadow_segments"):
        if mine[key] != mega[key]:
            raise SmokeFailure(f"{label}: {key} {mine[key]} against the "
                               f"megakernel's {mega[key]}")
    res = {"launches": la, **compare_engines("flagship", img, flag_img)}
    one = [engine_image(scene, camera, cfg, "wavefront", 1)
           for _ in range(2)]
    res["repeat_equal"] = bool(torch.equal(one[0], one[1]))
    print(f"{label}: a second run of one step is "
          f"{'equal bit for bit' if res['repeat_equal'] else 'DIFFERENT'}",
          flush=True)
    if not res["repeat_equal"]:
        raise SmokeFailure(f"{label}: two runs of one step differ")
    return res


def media_renders(media, card, flat_names, flat_routes):
    """The media scenes through the megakernel at full size (the grid
    scenes' profiles with the walks' device time, ``volume_walk_ms``),
    then smoke_demo through the wavefront engine (one timed step) against
    the megakernel's image of the same two samples. Returns each render's
    launches by label."""
    out = {}
    for name, (sc, cam, cfg, _) in media.items():
        _, out[name] = timed_render(
            name, sc, cam, cfg, card, flat_names,
            min_mean=MIN_MEAN.get(name, 0.05),
            ranges=volume_targets() if name in VOLUME_SCENES else None)
        check_routes(name, out[name], flat_routes)
    sc, cam, cfg, _ = media["smoke_demo"]
    label = "smoke_demo wavefront"
    wcfg = dataclasses.replace(cfg, engine="wavefront",
                               wavefront_pool=WAVEFRONT_POOL)
    img, out[label] = timed_render(label, sc, cam, wcfg, card, flat_names,
                                   steps=1, ranges=volume_targets(),
                                   engine="wavefront")
    check_routes(label, out[label], flat_routes)
    compare_engines(label, img, engine_image(sc, cam, cfg, "megakernel", 2))
    return out


def small_wavefront_checks(media, lights_scene, lights_cam_cfg,
                           inst_cam_cfg, inst_config, cam_cfg):
    """Small renders through the wavefront pool, kernels against plain
    versions: an instanced field with object motion (rows 4-5, per-slot
    shutter times), many_lights_demo (row 3; its plain route indexes the
    table's columns), cornell_mesh(3) paged by 16 (row 6) and sss_demo
    (the ``sss`` row in the pool). Returns the kernel launches of each."""
    from pathtracing_tpu_torch.models import scenes

    out = {}
    motion = make_motion_demo(grid=6, subdivisions=2)
    out["instanced motion"] = small_render_check(
        "instanced field with motion", motion, motion, inst_cam_cfg,
        inst_config.background, engine="wavefront")
    check_routes("small wavefront instanced motion", out["instanced motion"],
                 ("trace_inst", "occluded_inst"))
    unpacked = lights_scene._replace(
        lights=lights_scene.lights._replace(packed=None))
    out["many_lights_demo"] = small_render_check(
        "many_lights_demo", lights_scene, unpacked, lights_cam_cfg, "black",
        engine="wavefront")
    check_routes("small wavefront many_lights_demo", out["many_lights_demo"],
                 ("trace", "occluded", "gather_rows"))
    paged = scenes.cornell_mesh_builder(3).build(DEVICE, page_clusters=16)
    out["cornell_mesh(3) paged by 16"] = small_render_check(
        "cornell_mesh(3) paged by 16", paged, paged, cam_cfg, "black",
        engine="wavefront")
    check_routes("small wavefront paged", out["cornell_mesh(3) paged by 16"],
                 ("trace_paged_dnf", "occluded_paged_dnf"))
    sc, _, cfg, cc = media["sss_demo"]
    out["sss_demo"] = small_render_check("sss_demo", sc, sc, cc,
                                         cfg.background, engine="wavefront")
    check_routes("small wavefront sss_demo", out["sss_demo"],
                 ("trace", "occluded"))
    return out


def engine_image(scene, camera, config, engine, steps):
    """The resolved image of ``steps`` progressive steps of ``engine`` from
    sample 0 (untimed)."""
    from pathtracing_tpu_torch.models import progressive

    state = progressive.init_state(config, device=DEVICE)
    for _ in range(steps):
        state = step_fn(engine)(state, scene, camera, config)
    return progressive.resolve(state)


def compare_engines(label, wave_img, mega_img):
    """The wavefront image against the megakernel's of the same samples:
    the largest per-pixel difference, printed, within
    ``WAVEFRONT_IMAGE_TOL``."""
    diff = (wave_img - mega_img).abs()
    worst = float(diff.max())
    res = {"max_abs_diff": worst,
           "pixels_differing": int((diff.amax(-1) > 0).sum()),
           "tolerance": WAVEFRONT_IMAGE_TOL}
    print(f"wavefront vs megakernel {label} " + json.dumps(res), flush=True)
    if not worst <= WAVEFRONT_IMAGE_TOL:
        raise SmokeFailure(f"{label}: the wavefront image parts from the "
                           f"megakernel's by {worst}")
    return res


def binning_ab(tree_scene, camera, config, failures):
    """Rows 7-8 on the unpaged cornell_mesh(8)'s camera, bounce and shadow
    waves, binned and unbinned: each kernel's ms on the wave as it comes
    and on the wave sorted into (cell, octant) bins (``binning.ray_bin``,
    the sort the renders now take), the binning's own ms (bins, the
    permutation, the gathers in and the restore out), and the binned
    results mapped back through the inverse against the unbinned ones:
    equal bit for bit, or within the tie contract for the closest hit
    (every lane that parts is counted and printed)."""
    import torch

    from pathtracing_tpu_torch.ops import binning
    from pathtracing_tpu_torch.ops import cluster_trace as ct

    phase("binning A/B: rows 7-8")
    flat = tree_scene.clusters
    lo = torch.amin(flat.aabb_min, dim=0)
    hi = torch.amax(flat.aabb_max, dim=0)
    waves = make_waves(tree_scene, camera, config)
    out = {}
    for wname, name, kernel in (
            ("camera", "trace_tree", ct.trace_tree),
            ("bounce", "trace_tree", ct.trace_tree),
            ("camera_shadow", "occluded_tree", ct.occluded_tree),
            ("bounce_shadow", "occluded_tree", ct.occluded_tree)):
        o, d, cap = waves[wname]

        def sort(o=o, d=d, cap=cap):
            bins = binning.ray_bin(o, d, lo, hi, cap > 0.0)
            perm, inv = binning.binning_perm(bins, binning.N_BINS)
            return perm, inv, o[perm], d[perm], cap[perm]

        sort()
        sort_ms, (perm, inv, ob, db, cb) = cuda_ms(sort, KERNEL_REPS)
        kernel(flat, o, d, cap)
        ms_u, res_u = cuda_ms(lambda: kernel(flat, o, d, cap), KERNEL_REPS)
        ms_b, res_b = cuda_ms(lambda: kernel(flat, ob, db, cb), KERNEL_REPS)
        if not isinstance(res_u, tuple):
            res_u, res_b = (res_u,), (res_b,)
        restore_ms, back = cuda_ms(lambda: tuple(x[inv] for x in res_b),
                                   KERNEL_REPS)
        differ = torch.zeros_like(cap, dtype=torch.bool)
        for a, b in zip(res_u, back):
            same = (a == b) if a.dim() == 1 else (a == b).all(dim=1)
            differ |= ~same
        live = cap > 0
        bad = differ if name == "occluded_tree" else ~tie_ok(res_u, back,
                                                             live)
        rec = {"rays": int(cap.shape[0]), "live": int(live.sum()),
               "unbinned_ms": ms_u, "binned_ms": ms_b,
               "binning_ms": sort_ms + restore_ms, "sort_ms": sort_ms,
               "restore_ms": restore_ms, "lanes_differing": int(
                   differ.sum()), "tie_contract_fails": int(bad.sum()),
               "bins_used": int(torch.unique(binning.ray_bin(
                   o, d, lo, hi, live)).numel())}
        print(f"binning {name} " + json.dumps({"wave": wname, **rec}),
              flush=True)
        out.setdefault(name, {})[wname] = rec
        if int(bad.sum()):
            failures.append(f"binning changed {int(bad.sum())} {name} "
                            f"results on the {wname} wave")
    del waves
    return out



def reset_launches():
    from pathtracing_tpu_torch.ops import cluster_trace as ct
    from pathtracing_tpu_torch.ops import pgather

    ct.reset_launches()
    pgather.reset_launches()


def synced_s(fn):
    """(seconds of ``fn()`` to a synchronized card, its result)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def image_gate(label, image, min_mean=0.05, shape=None):
    """Finite, of the expected shape, with a mean in (min_mean, 5)."""
    import torch

    shape = (HEIGHT, WIDTH, 3) if shape is None else shape
    if tuple(image.shape) != shape:
        raise SmokeFailure(f"{label}: image shape {tuple(image.shape)}")
    if not bool(torch.isfinite(image).all()):
        raise SmokeFailure(f"{label}: image has non-finite values")
    mean = float(image.mean())
    if not min_mean < mean < 5.0:
        raise SmokeFailure(f"{label}: image mean {mean} outside "
                           f"({min_mean}, 5)")
    return mean


def equal_spp_checks(scene, camera, config):
    """Bands and tiles, every unit picked each round for EQUAL_SPP rounds,
    and ``uniform_tile_rounds``: each must give ``progressive.render_step``'s
    sums of the same samples bit for bit (a rows-mode and a pixels-mode wave
    of the whole frame a sample). Returns the band and tile states (every
    unit at EQUAL_SPP samples), from which the schedulers' next greedy
    round picks."""
    import torch

    from pathtracing_tpu_torch.models import adaptive, progressive

    t = phase("equal-spp identity: bands and tiles against progressive")
    ref = progressive.init_state(config, device=DEVICE)
    for _ in range(EQUAL_SPP):
        ref = progressive.render_step(ref, scene, camera, config)
    n_bands = HEIGHT // BAND_ROWS
    n_tiles = (HEIGHT // TILE) * (WIDTH // TILE)
    bands = adaptive.init_state(config, BAND_ROWS, device=DEVICE)
    tiles = adaptive.init_tile_state(config, TILE, device=DEVICE)
    uniform = adaptive.init_tile_state(config, TILE, device=DEVICE)
    for _ in range(EQUAL_SPP):
        bands = adaptive.adaptive_step(
            bands, scene, camera, config, BAND_ROWS,
            torch.arange(n_bands, device=DEVICE))
        tiles = adaptive.tile_step(tiles, scene, camera, config, TILE,
                                   torch.arange(n_tiles, device=DEVICE))
    uniform = adaptive.uniform_tile_rounds(uniform, scene, camera, config,
                                           TILE, EQUAL_SPP)

    def untile(st):
        return st.accum.reshape(HEIGHT // TILE, WIDTH // TILE, TILE, TILE,
                                3).permute(0, 2, 1, 3, 4).reshape(
                                    HEIGHT, WIDTH, 3)

    out = {}
    for label, accum in (("bands", bands.accum), ("tiles", untile(tiles)),
                         ("uniform_tile_rounds", untile(uniform))):
        diff = (accum - ref.accum).abs()
        out[label] = {"equal": bool(torch.equal(accum, ref.accum)),
                      "max_abs_diff": float(diff.max()),
                      "pixels_differ": int((diff.amax(-1) > 0).sum())}
    print("equal spp " + json.dumps({
        "spp": EQUAL_SPP, "bands": n_bands, "tiles": n_tiles, **out,
        "seconds": time.perf_counter() - t}), flush=True)
    for label, res in out.items():
        if not res["equal"]:
            raise SmokeFailure(f"equal-spp {label} differ from progressive "
                               f"on {res['pixels_differ']} pixels")
    return bands, tiles


def scheduler_waves(scene, camera, config, bands, tiles, results, failures):
    """Rows 1-2 on the schedulers' own waves at 1080p: the K = 16 bands
    and the K = 4,050 tiles a greedy round picks from ``bands`` and
    ``tiles`` (every unit at EQUAL_SPP samples), each ray at its unit's
    sample counter; the camera, bounce and both shadow waves of each,
    held bit for bit against the plain versions (and the tie contract
    against ``trace_torch``), timed against their bounds. Each wave's
    launches come from one scattered render of that wave with the counts
    set to 0 just before it. Results join ``results`` as
    "rows:<wave>" and "pixels:<wave>"; returns the launches by mode."""
    import torch

    from pathtracing_tpu_torch.models import adaptive, megakernel

    t = phase("kernels vs plain: the schedulers' rows and pixels waves")
    n_bands = HEIGHT // BAND_ROWS
    n_tiles = (HEIGHT // TILE) * (WIDTH // TILE)
    k_band, k_tile = max(1, n_bands // 8), max(1, n_tiles // 8)
    band_ids = adaptive.top_k(adaptive.band_scores(bands, config,
                                                   BAND_ROWS), k_band)
    tile_ids = adaptive.top_k(adaptive.tile_scores(tiles, config, TILE),
                              k_tile)
    rows = (band_ids[:, None] * BAND_ROWS + torch.arange(
        BAND_ROWS, device=DEVICE)[None, :]).reshape(-1)
    row_start = torch.repeat_interleave(
        bands.band_spp[band_ids].long(), BAND_ROWS)
    xs = torch.arange(WIDTH, device=DEVICE)
    pix = adaptive._tile_pixel_ids(tile_ids, config, TILE)
    pix_start = torch.repeat_interleave(tiles.tile_spp[tile_ids].long(),
                                        TILE * TILE)
    modes = {
        "rows": ((rows[:, None] * WIDTH + xs[None, :]).reshape(-1),
                 torch.repeat_interleave(row_start, WIDTH),
                 dict(rows=rows, rows_sample_start=row_start)),
        "pixels": (pix, pix_start,
                   dict(pixels=pix, pixels_sample_start=pix_start)),
    }
    tk, tp, ok, op, oracle, occ_oracle = flat_fns(scene.clusters)
    boxes = (scene.clusters.aabb_min, scene.clusters.aabb_max)
    n_clusters = scene.clusters.woop.shape[0]
    launches = {}
    for mode, (wave_pix, wave_sample, kw) in modes.items():
        reset_launches()
        megakernel.render_samples(scene, camera, config, 0, 1, config.seed,
                                  **kw)
        torch.cuda.synchronize()
        launches[mode] = {k: v for k, v in launch_counts().items() if v}
        waves = make_waves(scene, camera, config, pix=wave_pix,
                           sample=wave_sample)
        for wname in ("camera", "bounce", "camera_shadow", "bounce_shadow"):
            if wname.endswith("shadow"):
                key, kname = "occluded", "occluded_dnf"
                res = check_occluded(ok, op, waves[wname],
                                     reference=occ_oracle, boxes=boxes)
                ray_bytes = 29
            else:
                key, kname = "trace", "trace_dnf"
                res = check_trace(tk, tp, waves[wname], strict=True,
                                  normal_tol=0.0, reference=oracle,
                                  boxes=boxes)
                ray_bytes = 52
            b_ms, b_by, _, _ = bound_ms(res["needed_evals"], res["rays"],
                                        n_clusters, ray_bytes)
            results[key][f"{mode}:{wname}"] = res
            report(kname, res, failures, wave=f"{mode}:{wname}",
                   bound_ms=b_ms, bound_by=b_by,
                   launches_a_wave=launches[mode][key])
        del waves
    print(f"scheduler waves: {k_band} bands ({modes['rows'][0].shape[0]} "
          f"rays), {k_tile} tiles ({pix.shape[0]} rays), launches "
          f"{json.dumps(launches)} ({time.perf_counter() - t:.2f} s)",
          flush=True)
    return launches


def adaptive_renders(scene, camera, config, card, flat_names):
    """The two schedulers' budgeted renders at 1080p (ADAPTIVE_BUDGET spp,
    ADAPTIVE_WARMUP warmup): seconds, rounds, spp spent, the image gate
    and the launches, which must be rows 1-2 and no other kernel; one
    greedy tile round under the profiler; then a tile render with
    ``target_rmse``. Returns their numbers by label."""
    from pathtracing_tpu_torch.models import adaptive

    phase("adaptive renders")
    out = {}
    n_px = WIDTH * HEIGHT
    runs = {
        "tiles": lambda **kw: adaptive.render_adaptive_tiles(
            scene, camera, config, tile=TILE, warmup_spp=ADAPTIVE_WARMUP,
            spp_per_round=TILE_SPP_PER_ROUND, **kw),
        "bands": lambda **kw: adaptive.render_adaptive(
            scene, camera, config, band_rows=BAND_ROWS,
            warmup_spp=ADAPTIVE_WARMUP, **kw),
    }
    states = {}
    for label, run_fn in runs.items():
        reset_launches()
        secs, (state, rounds) = synced_s(
            lambda: run_fn(budget_spp=ADAPTIVE_BUDGET))
        la = launch_counts()
        check_routes(f"adaptive {label}", la, ("trace", "occluded"))
        if label == "tiles":
            img = adaptive.resolve_tiles(state, config, TILE)
            spent = int(state.tile_spp.sum()) * TILE * TILE
        else:
            img = adaptive.resolve(state, BAND_ROWS)
            spent = int(state.band_spp.sum()) * BAND_ROWS * WIDTH
        states[label] = state
        out[label] = {"seconds": secs, "rounds": rounds,
                      "spp_spent": spent / n_px,
                      "image_mean": image_gate(f"adaptive {label}", img),
                      "launches": {k: v for k, v in la.items() if v},
                      "card": card}
        print(f"adaptive {label} " + json.dumps(out[label]), flush=True)
    tiles = states["tiles"]
    k = max(1, tiles.tile_spp.shape[0] // 8)
    prof = profile_step(lambda: adaptive.tile_rounds(
        tiles, scene, camera, config, TILE, k, 1, TILE_SPP_PER_ROUND),
        flat_names)
    out["tiles"]["profile_greedy_round"] = prof
    print("profile adaptive tiles greedy round " + json.dumps(prof),
          flush=True)
    target = float(adaptive.predicted_rmse(states["tiles"], config, TILE))
    log = []
    reset_launches()
    secs, (state, rounds) = synced_s(lambda: runs["tiles"](
        budget_spp=2 * ADAPTIVE_BUDGET, target_rmse=target,
        progress=lambda st, spent, budget: log.append(spent)))
    check_routes("adaptive target_rmse", launch_counts(),
                 ("trace", "occluded"))
    out["target_rmse"] = {
        "seconds": secs, "rounds": rounds, "target_rmse": target,
        "predicted_rmse_at_stop": float(adaptive.predicted_rmse(
            state, config, TILE)),
        "spp_spent": int(state.tile_spp.sum()) * TILE * TILE / n_px,
        "budget_spp": 2 * ADAPTIVE_BUDGET, "groups": len(log),
        "image_mean": image_gate("adaptive target_rmse",
                                 adaptive.resolve_tiles(state, config,
                                                        TILE)),
        "card": card}
    print("adaptive target_rmse " + json.dumps(out["target_rmse"]),
          flush=True)
    return out


def post_passes(scene, camera, cam_cfg, config, card, flag_img, textured):
    """The post-passes at 1080p: all five AOVs of the flagship (uv and
    albedo also of ``textured``, (scene, camera)), each finite and in
    [0, 1]; ``denoise_render`` and ``apply_bloom`` of the flagship's
    image (TIMED_STEPS + 1 spp): seconds, then device ms and device ops
    of a profiled run; a TEMPORAL_FRAMES-frame orbit through
    ``temporal.advance`` at 1 spp a frame: seconds a frame and the share
    of pixels that reused history. Returns the numbers."""
    import torch

    import numpy as np

    from pathtracing_tpu_torch.models import aov, megakernel, temporal
    from pathtracing_tpu_torch.ops import bloom, denoise
    from pathtracing_tpu_torch.ops.camera import build_camera

    phase("post-passes: AOVs, denoiser, bloom, temporal")
    out = {"aov": {}}
    cases = [("flagship", scene, camera, kind) for kind in aov.AOV_KINDS]
    cases += [("textured_demo", *textured, kind) for kind in ("uv",
                                                             "albedo")]
    for label, sc, cam, kind in cases:
        secs, img = synced_s(lambda: aov.render_aov(sc, cam, config, kind))
        ok = (bool(torch.isfinite(img).all()) and float(img.min()) >= 0.0
              and float(img.max()) <= 1.0
              and tuple(img.shape) == (HEIGHT, WIDTH, 3))
        out["aov"][f"{label}:{kind}"] = {"seconds": secs,
                                         "mean": float(img.mean())}
        if not ok:
            raise SmokeFailure(f"AOV {kind} of {label} is not finite in "
                               "[0, 1]")
    print("aov " + json.dumps(out["aov"]), flush=True)
    spp = TIMED_STEPS + 1
    for label, fn in (
            ("denoise_render", lambda: denoise.denoise_render(
                scene, camera, config, flag_img, spp=spp)),
            ("apply_bloom", lambda: bloom.apply_bloom(flag_img,
                                                      BLOOM_STRENGTH))):
        secs, img = synced_s(fn)
        image_gate(label, img)
        prof = profile_step(fn, ())
        out[label] = {"seconds": secs, "device_ms": prof["device_ms"],
                      "device_ops": prof.get("device_ops"),
                      "busy_share": prof.get("busy_share"),
                      "image_mean": float(img.mean()), "card": card}
        print(f"{label} " + json.dumps(out[label]), flush=True)
    # A small orbit about the look-at point, 2 degrees a frame.
    base = np.asarray(cam_cfg.position, np.float32)
    target = np.asarray(cam_cfg.look_at, np.float32)
    rel = base - target
    r_xz = float(np.hypot(rel[0], rel[2]))
    phi0 = float(np.arctan2(rel[0], rel[2]))
    state = temporal.init_state(config, device=DEVICE)
    prev = None
    frames = []
    for i in range(TEMPORAL_FRAMES):
        phi = phi0 + np.radians(2.0) * i
        pos = target + np.array([r_xz * np.sin(phi), rel[1],
                                 r_xz * np.cos(phi)], np.float32)
        cam = build_camera(dataclasses.replace(
            cam_cfg, position=tuple(map(float, pos))), WIDTH / HEIGHT,
            device=DEVICE)

        def frame():
            cur = megakernel.render_samples(scene, cam, config, i, 1,
                                            config.seed)
            return temporal.advance(state, cur, scene, cam,
                                    cam if prev is None else prev, config)

        secs, (img, state) = synced_s(frame)
        image_gate(f"temporal frame {i}", img)
        frames.append({"seconds": secs, "accepted_share": float(
            (state.hist_len > 1.0).float().mean())})
        prev = cam
    out["temporal"] = {"frames": frames, "card": card}
    print("temporal " + json.dumps(out["temporal"]), flush=True)
    if frames[-1]["accepted_share"] < 0.5:
        raise SmokeFailure("the temporal orbit reused history on less than "
                           "half the pixels")
    return out


def example_scenes(card):
    """Each scene of the repository's examples/ loaded on the card (host
    seconds), then one timed 1-spp 1080p step (no profile) through the
    route its routing picks, with the launch counts set to 0 just before
    it; the image gate. Returns the numbers by file."""
    import torch

    from pathtracing_tpu_torch.models import gltf, progressive, scene_io
    from pathtracing_tpu_torch.models import scene as scene_mod
    from pathtracing_tpu_torch.ops.camera import build_camera
    from pathtracing_tpu_torch.utils.config import RenderConfig

    t = phase("example scenes (file loaders)")
    out = {}
    for name in EXAMPLE_SCENES:
        path = os.path.join(ROOT, "examples", name)
        load_s, (sc, cc) = synced_s(
            lambda: (scene_io.load_scene(path, device=DEVICE)
                     if name.endswith(".json")
                     else gltf.load_gltf(path, device=DEVICE)))
        bg = (scene_io.preferred_background(path) if name.endswith(".json")
              else "black")
        pair = cc.motion_pair()
        cam = (build_camera(cc, WIDTH / HEIGHT, device=DEVICE) if pair is None
               else tuple(build_camera(c, WIDTH / HEIGHT, device=DEVICE)
                          for c in pair))
        cfg = RenderConfig(width=WIDTH, height=HEIGHT, samples_per_pixel=1,
                           max_depth=DEPTH, samples_per_step=1, seed=0,
                           nee=True, sampler="ld", background=bg)
        route = scene_mod.cluster_route(sc)
        state = progressive.init_state(cfg, device=DEVICE)
        stats = {}
        reset_launches()
        step_s, state = synced_s(lambda: progressive.render_step(
            state, sc, cam, cfg, stats=stats))
        la = launch_counts()
        check_routes(f"example {name}", la, ROUTE_COUNTERS[route],
                     optional=("gather_rows",))
        segments = int(stats["segments"]) + int(stats["shadow_segments"])
        out[name] = {
            "load_s": load_s, "step_s": step_s, "route": route,
            "triangles": int(sc.tri_v0.shape[0]),
            "mrays_per_s": segments / step_s / 1e6,
            "image_mean": image_gate(f"example {name}",
                                     progressive.resolve(state)),
            "launches": {k: v for k, v in la.items() if v}, "card": card}
        print(f"example {name} " + json.dumps(out[name]), flush=True)
        del sc, state
        torch.cuda.empty_cache()
    print(f"example scenes: {time.perf_counter() - t:.2f} s", flush=True)
    return out


# The app shell (python -m pathtracing_tpu_torch.render) and parallel/
# phases. The shell's flagship run is interrupted after SHELL_STOP of
# SHELL_SPP steps (a checkpoint's fingerprint covers --spp, so a resume
# keeps the interrupted run's flags) and resumed to SHELL_SPP; the other
# branches run once at BRANCH_SIZE and 1 spp.
SHELL_SPP, SHELL_STOP, SHELL_SNAPSHOT_EVERY = 6, 4, 2
BRANCH_SIZE = (480, 270)
SHELL_TILES, SHELL_FAULT_BAND = 4, 1
LAYOUTS = ((4, 1), (2, 2), (1, 4))
LAYOUT_SPP = 4               # samples a step of the layout simulation
# The JAX package's tolerance for a samples axis (tests/test_parallel.py).
SAMPLE_AXIS_RTOL, SAMPLE_AXIS_ATOL = 1e-6, 1e-5


@contextlib.contextmanager
def flagship_registry(scene, cam_cfg):
    """``--scene cornell_mesh`` names the flagship's cornell_mesh(6),
    already built on the card (the registry's default is 5)."""
    from pathtracing_tpu_torch.models import scenes

    real = scenes.SCENES["cornell_mesh"]
    scenes.SCENES["cornell_mesh"] = lambda device=None: (scene, cam_cfg)
    try:
        yield
    finally:
        scenes.SCENES["cornell_mesh"] = real


def shell(argv, label, card):
    """``render.main(argv)`` in-process: (seconds to a synchronized card,
    launches); fails unless it exits 0."""
    from pathtracing_tpu_torch import render

    reset_launches()
    secs, rc = synced_s(lambda: render.main(argv))
    la = launch_counts()
    if rc != 0:
        raise SmokeFailure(f"app shell {label}: exit {rc}")
    print(f"app shell {label}: {secs:.3f} s, launches "
          f"{ {k: v for k, v in la.items() if v} } on {card}", flush=True)
    return secs, la


def app_shell(scene, cam_cfg, config, card):
    """The CLI on the flagship at 1080p (module docstring, phase 4).
    Returns its numbers, and the accumulator of the direct 2-spp
    progressive render the parallel phase compares with."""
    import tempfile

    import numpy as np
    import torch

    from pathtracing_tpu_torch.models import progressive
    from pathtracing_tpu_torch.ops.camera import build_camera

    t = phase("app shell: render.main on the flagship")
    out = {"card": card}
    tmp = tempfile.mkdtemp(prefix="app_shell_")
    ck, jl, hdr = (os.path.join(tmp, n) for n in ("ck.npz", "m.jsonl",
                                                  "r.npz"))
    common = ["--scene", "cornell_mesh", "--width", str(WIDTH),
              "--height", str(HEIGHT), "--max-depth", str(DEPTH),
              "--seed", "0", "--spp-per-step", "1"]
    flag = [*common, "--spp", str(SHELL_SPP), "--checkpoint", ck,
            "--snapshot-every", str(SHELL_SNAPSHOT_EVERY),
            "--metrics-jsonl", jl, "--out-hdr", hdr,
            "--out", os.path.join(tmp, "flagship.png")]

    # The uninterrupted progressive render the resume must equal, stepped
    # directly: also the shell's overhead a step.
    camera = build_camera(cam_cfg, WIDTH / HEIGHT, device=DEVICE)
    ref = progressive.init_state(config, device=DEVICE)
    direct_s, accums = [], {}
    for _ in range(SHELL_SPP):
        secs, ref = synced_s(lambda: progressive.render_step(
            ref, scene, camera, config))
        direct_s.append(secs)
        if ref.spp == EQUAL_SPP:
            accums[ref.spp] = ref.accum.clone()
    want = progressive.resolve(ref)

    real_step, calls = progressive.render_step, []

    def interrupted(*a, **k):
        # Ctrl-C during step SHELL_STOP + 1: the CLI checkpoints the
        # state of SHELL_STOP steps on its way out.
        calls.append(1)
        if len(calls) > SHELL_STOP:
            raise KeyboardInterrupt
        return real_step(*a, **k)

    with flagship_registry(scene, cam_cfg):
        progressive.render_step = interrupted
        try:
            first_s, la_first = shell(flag, "flagship (interrupted)", card)
        finally:
            progressive.render_step = real_step
        with np.load(hdr) as data:
            if int(data["spp"]) != SHELL_STOP:
                raise SmokeFailure(f"the interrupted run wrote {data['spp']}"
                                   " spp")
        resume_s, la_resume = shell(flag, "flagship (resumed)", card)
        with np.load(hdr) as data:
            got, spp = torch.as_tensor(data["radiance"]), int(data["spp"])
        with open(jl) as f:
            steps = [json.loads(line) for line in f]
        # --seed 7: a resume under another config is refused (exit 2).
        from pathtracing_tpu_torch import render

        refused = render.main([*flag[:-2], "--seed", "7", "--out",
                               os.path.join(tmp, "x.png")])
        for la, label in ((la_first, "flagship"), (la_resume, "resume")):
            check_routes(f"app shell {label}", la, ("trace", "occluded"))
        diff = (got - want.cpu()).abs()
        step_s = [s["seconds"] for s in steps]
        # Steps whose timer holds the write of the previous step's
        # snapshot (the asynchronous present) against the others.
        snap = [s["seconds"] for s in steps
                if s["step"] > 1 and (s["step"] - 1) % SHELL_SNAPSHOT_EVERY
                == 0 and s["step"] != SHELL_STOP + 1]
        plain = [s["seconds"] for s in steps if s["step"] > 1
                 and (s["step"] - 1) % SHELL_SNAPSHOT_EVERY != 0]
        out["flagship"] = {
            "resume_equal": bool(torch.equal(got, want.cpu())),
            "max_abs_diff": float(diff.max()), "spp": spp,
            "refused_other_seed": refused,
            "metrics_steps": [s["step"] for s in steps],
            "step_s": step_s, "direct_step_s": direct_s,
            "shell_overhead_s": (sum(plain) / len(plain)
                                 - sum(direct_s[1:]) / len(direct_s[1:])),
            "snapshot_step_s": snap, "plain_step_s": plain,
            "first_run_s": first_s, "resume_run_s": resume_s,
            "launches": {k: la_first[k] + la_resume[k]
                         for k in la_first if la_first[k] + la_resume[k]}}
        if spp != SHELL_SPP or not out["flagship"]["resume_equal"]:
            raise SmokeFailure(f"app shell resume: {spp} spp, max diff "
                               f"{out['flagship']['max_abs_diff']}")
        if refused != 2:
            raise SmokeFailure(f"a resume under another seed exited "
                               f"{refused}")
        if len(steps) != SHELL_SPP:
            raise SmokeFailure(f"metrics log has {len(steps)} steps")

        # Band tiles with an injected fault against the 2-spp render.
        secs, la = shell([*common, "--spp", str(EQUAL_SPP), "--tiles",
                          str(SHELL_TILES), "--inject-fault",
                          str(SHELL_FAULT_BAND), "--out-hdr", hdr,
                          "--out", os.path.join(tmp, "tiles.png")],
                         "tiles with a fault", card)
        check_routes("app shell tiles", la, ("trace", "occluded"))
        with np.load(hdr) as data:
            tiled = torch.as_tensor(data["radiance"])
        two = (accums[EQUAL_SPP] / float(EQUAL_SPP)).cpu()
        out["tiles_fault"] = {"seconds": secs, "equal": bool(torch.equal(
            tiled, two)), "max_abs_diff": float((tiled - two).abs().max()),
            "launches": {k: v for k, v in la.items() if v}}
        if not out["tiles_fault"]["equal"]:
            raise SmokeFailure("the tiled render with a fault differs from "
                               "progressive")

        # The other branches, once each at BRANCH_SIZE and 1 spp.
        small = ["--width", str(BRANCH_SIZE[0]), "--height",
                 str(BRANCH_SIZE[1]), "--max-depth", str(DEPTH), "--spp",
                 "1", "--spp-per-step", "1"]
        branches = {
            "adaptive": (["--scene", "cornell_mesh", "--adaptive",
                          "--adaptive-tile", "10"], ("trace", "occluded")),
            "orbit temporal denoise": (["--scene", "cornell_mesh", "--orbit",
                                        "2", "--orbit-degrees", "4",
                                        "--temporal", "--denoise"],
                                       ("trace", "occluded")),
            "aov normal": (["--scene", "cornell_mesh", "--aov", "normal"],
                           ("trace",)),
            "cornell.json": (["--scene", os.path.join(ROOT, "examples",
                                                       "cornell.json")],
                             ("trace", "occluded")),
        }
        out["branches"] = {}
        for label, (extra, used) in branches.items():
            name = label.split()[0].replace(".", "_")
            secs, la = shell([*small, *extra, "--out",
                              os.path.join(tmp, name + ".png")], label, card)
            check_routes(f"app shell {label}", la, used)
            out["branches"][label] = {
                "seconds": secs,
                "launches": {k: v for k, v in la.items() if v}}
    out["seconds"] = time.perf_counter() - t
    print("app shell " + json.dumps(out), flush=True)
    return out, accums


def parallel_phase(scene, cam_cfg, config, card, accums):
    """``parallel/`` on the one card (module docstring, phase 4): two
    sharded 1-spp steps at a world size of 1 over NCCL, the layout
    simulation, and ``render_adaptive_sharded`` against
    ``render_adaptive_tiles``. Returns its numbers."""
    import socket

    import torch
    import torch.distributed as dist

    from pathtracing_tpu_torch.models import adaptive, progressive
    from pathtracing_tpu_torch.ops.camera import build_camera
    from pathtracing_tpu_torch.parallel import adaptive as padaptive
    from pathtracing_tpu_torch.parallel import mesh as mesh_mod
    from pathtracing_tpu_torch.parallel import render as prender

    t = phase("parallel: sharded steps, layout simulation, sharded adaptive")
    out = {"card": card}
    camera = build_camera(cam_cfg, WIDTH / HEIGHT, device=DEVICE)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        init_s, device = synced_s(lambda: mesh_mod.multihost_init(DEVICE))
        mesh = mesh_mod.make_mesh(1, 1, device=device)
        backend = "nccl" if DEVICE == "cuda" else "gloo"
        if dist.get_backend() != backend or mesh.device != device:
            raise SmokeFailure(f"world of 1 on {dist.get_backend()}, "
                               f"{device}, mesh on {mesh.device}")
        step = prender.make_sharded_step(mesh, config)
        state = prender.init_sharded_state(mesh, config)
        reset_launches()
        steps_s = []
        for _ in range(EQUAL_SPP):
            secs, state = synced_s(lambda: step(state, scene, camera))
            steps_s.append(secs)
        la = launch_counts()
        check_routes("sharded step", la, ("trace", "occluded"))
        img = prender.gather_image(state, mesh)
        ref = accums[EQUAL_SPP]
        out["world1"] = {
            "init_s": init_s, "step_s": steps_s,
            "equal": bool(torch.equal(state.accum, ref)),
            "image_equal": bool(torch.equal(img, ref / float(EQUAL_SPP))),
            "max_abs_diff": float((state.accum - ref).abs().max()),
            "launches": {k: v for k, v in la.items() if v}}
        if not (out["world1"]["equal"] and out["world1"]["image_equal"]):
            raise SmokeFailure("the sharded world-1 step differs from "
                               "progressive")

        # render_adaptive_sharded at a world size of 1 against the
        # one-process tile scheduler with the same k and spp a round.
        budget = dict(warmup_spp=ADAPTIVE_WARMUP, budget_spp=ADAPTIVE_BUDGET,
                      spp_per_round=TILE_SPP_PER_ROUND)
        k = (WIDTH // TILE) * (HEIGHT // TILE) // 8
        reset_launches()
        sh_s, (sh, sh_rounds) = synced_s(
            lambda: padaptive.render_adaptive_sharded(
                mesh, scene, camera, config, tile=TILE, tiles_per_round=k,
                **budget))
        la = launch_counts()
        check_routes("sharded adaptive", la, ("trace", "occluded"))
        one_s, (one, one_rounds) = synced_s(
            lambda: adaptive.render_adaptive_tiles(
                scene, camera, config, tile=TILE, tiles_per_round=k,
                **budget))
        sh_img = padaptive.gather_tile_image(sh, mesh, config, TILE)
        one_img = adaptive.resolve_tiles(one, config, TILE)
        out["adaptive"] = {
            "k": k, "sharded_s": sh_s, "one_process_s": one_s,
            "rounds": [sh_rounds, one_rounds],
            "accum_equal": bool(torch.equal(sh.accum, one.accum)),
            "m2_equal": bool(torch.equal(sh.m2, one.m2)),
            "tile_spp_equal": bool(torch.equal(sh.tile_spp, one.tile_spp)),
            "image_equal": bool(torch.equal(sh_img, one_img)),
            "tiles_differ": int(((sh.accum - one.accum).abs().amax(
                dim=(1, 2, 3)) > 0).sum()),
            "spp_spent": int(sh.tile_spp.sum()) * TILE * TILE
            / (WIDTH * HEIGHT),
            "launches": {k_: v for k_, v in la.items() if v}}
        del sh, one
        if not all(out["adaptive"][key] for key in (
                "accum_equal", "m2_equal", "tile_spp_equal", "image_equal")):
            raise SmokeFailure("sharded adaptive differs from "
                               "render_adaptive_tiles: "
                               + json.dumps(out["adaptive"]))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value

    # The layout simulation: every rank's rank_block of each layout on the
    # one card, merged in rank order, against one progressive step of
    # LAYOUT_SPP samples.
    cfg = dataclasses.replace(config, samples_per_step=LAYOUT_SPP)
    empty = progressive.init_state(cfg, device=DEVICE)
    ref = progressive.render_step(
        progressive.init_state(cfg, device=DEVICE), scene, camera,
        cfg).accum
    out["layouts"] = {}
    for n_tiles, n_samples in LAYOUTS:
        def simulate():
            stripes = []
            for tile in range(n_tiles):
                block = None
                for sample in range(n_samples):
                    part = prender.rank_block(scene, camera, cfg, empty,
                                              n_tiles, n_samples, tile,
                                              sample)
                    block = part if block is None else block + part
                stripes.append(block)
            return torch.cat(stripes)

        secs, got = synced_s(simulate)
        diff = (got - ref).abs()
        tol_ok = bool((diff <= SAMPLE_AXIS_ATOL
                       + SAMPLE_AXIS_RTOL * ref.abs()).all())
        res = {"seconds": secs, "equal": bool(torch.equal(got, ref)),
               "max_abs_diff": float(diff.max()),
               "pixels_differ": int((diff.amax(-1) > 0).sum()),
               "within_tolerance": tol_ok}
        out["layouts"][f"{n_tiles}x{n_samples}"] = res
        if (n_samples == 1 and not res["equal"]) or not tol_ok:
            raise SmokeFailure(f"layout {n_tiles}x{n_samples}: "
                               + json.dumps(res))
    out["seconds"] = time.perf_counter() - t
    print("parallel " + json.dumps(out), flush=True)
    return out


def run() -> dict:
    import torch

    t = phase("device")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; {kind}; devices {count}")

    from pathtracing_tpu_torch.models import scene as scene_mod
    from pathtracing_tpu_torch.models import scenes
    from pathtracing_tpu_torch.ops import cuda_build, texture
    from pathtracing_tpu_torch.ops.camera import build_camera
    from pathtracing_tpu_torch.utils.config import RenderConfig

    t = phase("build")
    libs = cuda_build.build_all()
    print(f"build: {sorted(os.path.relpath(p, ROOT) for p in libs.values())}"
          f" ({time.perf_counter() - t:.2f} s)", flush=True)
    ptxas = ptxas_report(libs)
    print("registers " + json.dumps(ptxas), flush=True)
    rng_res = rng_checks()

    def config_for(background="black"):
        return RenderConfig(
            width=WIDTH, height=HEIGHT, samples_per_pixel=TIMED_STEPS + 1,
            max_depth=DEPTH, samples_per_step=1, seed=0,
            engine="megakernel", nee=True, sampler="ld",
            background=background,
        )

    t = phase("scene")
    scene, cam_cfg = scenes.cornell_mesh(6, device=DEVICE)
    camera = build_camera(cam_cfg, WIDTH / HEIGHT, device=DEVICE)
    n_clusters = scene.clusters.woop.shape[0]
    print(f"cornell_mesh(6): {scene.tri_v0.shape[0]} triangles, "
          f"{n_clusters} clusters ({time.perf_counter() - t:.2f} s)",
          flush=True)
    config = config_for()

    phase("kernels vs plain: flat")
    failures = []
    waves = make_waves(scene, camera, config)
    results = {"trace": {}, "occluded": {}}
    tk, tp, ok, op, oracle, occ_oracle = flat_fns(scene.clusters)
    boxes = (scene.clusters.aabb_min, scene.clusters.aabb_max)
    for wname in ("camera", "bounce"):
        res = check_trace(tk, tp, waves[wname], strict=True, normal_tol=0.0,
                          reference=oracle, boxes=boxes)
        results["trace"][wname] = res
        report("trace_dnf", res, failures, wave=wname)
    for wname in ("camera_shadow", "bounce_shadow"):
        res = check_occluded(ok, op, waves[wname], reference=occ_oracle,
                             boxes=boxes)
        results["occluded"][wname] = res
        report("occluded_dnf", res, failures, wave=wname)
    del waves
    # A set of more clusters, with a less regular tree, than the flagship:
    # both kernels on a triangle soup.
    soup_cl, soup_waves = make_soup()
    tk, tp, ok, op, oracle, occ_oracle = flat_fns(soup_cl)
    n_soup = int(soup_cl.woop.shape[0])
    report("trace_dnf", check_trace(tk, tp, soup_waves["soup"], strict=True,
                                    normal_tol=0.0, reference=oracle),
           failures, wave="soup", clusters=n_soup)
    report("occluded_dnf", check_occluded(ok, op, soup_waves["soup_shadow"],
                                          reference=occ_oracle),
           failures, wave="soup_shadow", clusters=n_soup)
    del soup_cl, soup_waves

    t = phase("kernels vs plain: instanced")
    inst_scene, inst_cam_cfg = scenes.instanced_demo(device=DEVICE)
    inst_camera = build_camera(inst_cam_cfg, WIDTH / HEIGHT, device=DEVICE)
    inst_config = config_for(scenes.preferred_background("instanced_demo"))
    motion_scene = make_motion_demo()
    n_exp = int(inst_scene.instances.cmap.shape[0])
    n_proto = int(inst_scene.clusters.woop.shape[0])
    if inst_scene.instances.imat is None or motion_scene.instances.fw0 is None:
        raise SmokeFailure("instanced_demo lost its overrides or its motion")
    print(f"instanced_demo: {n_exp} expanded clusters over {n_proto} stored "
          f"({time.perf_counter() - t:.2f} s)", flush=True)
    waves = make_waves(inst_scene, inst_camera, inst_config)
    gen = torch.Generator(device="cpu").manual_seed(3)
    times = torch.rand(waves["camera"][0].shape[0], generator=gen).to(DEVICE)
    inst_results = {"trace": {}, "occluded": {}}
    variants = (
        ("static", inst_scene, ()),
        ("motion", motion_scene, (times,)),
        ("motion_mid", motion_scene, ()),
    )
    for vname, sc, extra in variants:
        tk, tp, ok, op = inst_fns(sc.clusters, sc.instances)
        boxes = (sc.instances.aabb_min, sc.instances.aabb_max)
        for wname in ("camera", "bounce"):
            res = check_trace(tk, tp, waves[wname] + extra,
                              chunk=INST_PLAIN_CHUNK, strict=True,
                              normal_tol=0.0, boxes=boxes)
            res["motion"] = vname != "static"
            inst_results["trace"][f"{vname}:{wname}"] = res
            report("trace_dnf_inst", res, failures, variant=vname,
                   wave=wname)
        for wname in ("camera_shadow", "bounce_shadow"):
            res = check_occluded(ok, op, waves[wname] + extra,
                                 chunk=INST_PLAIN_CHUNK, boxes=boxes)
            res["motion"] = vname != "static"
            inst_results["occluded"][f"{vname}:{wname}"] = res
            report("occluded_dnf_inst", res, failures, variant=vname,
                   wave=wname)
    del waves, motion_scene
    # Bigger fields: the 19x19 field (5,777 expanded clusters in 362
    # placements; the kernels' budget is 8,192), and a 33x33 field of
    # one-cluster icosahedra, 1,090 placements: two shared-memory chunks
    # of placement boxes, so a finished warp must still reach the second
    # chunk's barriers.
    pix = torch.randperm(WIDTH * HEIGHT, generator=gen)[:(1 << 18) + 13]
    for label, grid, subdiv in (("grid19", 19, 3), ("grid33", 33, 0)):
        big_scene, _ = scenes.instanced_demo(grid=grid, subdivisions=subdiv,
                                             device=DEVICE)
        big_inst = big_scene.instances
        sizes = {"expanded": int(big_inst.cmap.shape[0]),
                 "placements": int(big_inst.inst_first.shape[0]) - 1}
        big_waves = make_waves(big_scene, inst_camera, inst_config,
                               pix=pix.to(DEVICE), bounce=False)
        tk, tp, ok, op = inst_fns(big_scene.clusters, big_inst)
        report("trace_dnf_inst",
               check_trace(tk, tp, big_waves["camera"],
                           chunk=INST_PLAIN_CHUNK, strict=True,
                           normal_tol=0.0),
               failures, wave=label, **sizes)
        report("occluded_dnf_inst",
               check_occluded(ok, op, big_waves["camera_shadow"],
                              chunk=INST_PLAIN_CHUNK),
               failures, wave=label + "_shadow", **sizes)
        del big_scene, big_inst, big_waves

    t = phase("kernel vs plain: gather")
    lights_scene, lights_cam_cfg = scenes.many_lights_demo(device=DEVICE)
    lights_camera = build_camera(lights_cam_cfg, WIDTH / HEIGHT,
                                 device=DEVICE)
    gather_res = gather_checks(lights_scene, config, failures)

    t = phase("kernels vs plain: light transport waves")
    new = {name: scenes.get_scene(name, device=DEVICE)
           for name in NEW_SCENES}
    new_cams = {name: build_camera(cc, WIDTH / HEIGHT, device=DEVICE)
                for name, (_, cc) in new.items()}
    print(f"the nine new scenes built in {time.perf_counter() - t:.2f} s",
          flush=True)
    for name in ("envmap_demo", "spotlight_demo"):
        sc = new[name][0]
        _, _, ok, op, _, occ_oracle = flat_fns(sc.clusters)
        lt_waves = light_waves(sc, new_cams[name],
                               config_for(scenes.preferred_background(name)))
        for wname, wave in lt_waves.items():
            res = check_occluded(ok, op, wave, reference=occ_oracle,
                                 boxes=(sc.clusters.aabb_min,
                                        sc.clusters.aabb_max))
            res["n_clusters"] = int(sc.clusters.woop.shape[0])
            results["occluded"][f"{name}:{wname}"] = res
            report("occluded_dnf", res, failures, wave=wname, scene=name)
        del lt_waves
    sc = new["sphere_demo"][0]
    tk, tp, _, _, oracle, _ = flat_fns(sc.clusters)
    sphere_waves = make_waves(sc, new_cams["sphere_demo"],
                              config_for("gradient"), bounce=False)
    res = check_trace(tk, tp, sphere_waves["camera"], strict=True,
                      normal_tol=0.0, reference=oracle,
                      boxes=(sc.clusters.aabb_min, sc.clusters.aabb_max))
    res["n_clusters"] = int(sc.clusters.woop.shape[0])
    results["trace"]["sphere_demo:camera"] = res
    report("trace_dnf", res, failures, wave="camera", scene="sphere_demo",
           clusters=res["n_clusters"])
    del sphere_waves
    ris_idx = ris_candidates(lights_scene, lights_camera, config, RIS_M)
    ris_res = check_gather(lights_scene.lights.packed, ris_idx,
                           f"many_lights RIS candidates (M = {RIS_M})",
                           failures, timed=True)
    del ris_idx

    attr = {name: scenes.get_scene(name, device=DEVICE)
            for name in ATTR_SCENES}
    attr_cams = {name: build_camera(cc, WIDTH / HEIGHT, device=DEVICE)
                 for name, (_, cc) in attr.items()}
    attribute_wave_checks(attr, attr_cams, scene, cam_cfg, config, results,
                          failures)
    media = media_scenes()
    new_flat_waves(scene, camera, config, media, results, failures)

    big = big_scene_checks(camera, config, failures)
    textured_big = textured_big_checks(camera, config, failures)
    # An unpaged scene past the flat budget routes to the tree walks.
    tree_scene = big["scene"]._replace(clusters=big["flat"], pages=None)
    if scene_mod.cluster_route(tree_scene) != "tree":
        raise SmokeFailure("the unpaged big scene does not route to the tree")
    binning = binning_ab(tree_scene, camera, config, failures)
    field = field_checks(card, failures)
    if failures:
        raise SmokeFailure("kernel disagrees with its plain version: "
                           + "; ".join(failures))

    phase("renders")
    flat_names = ("trace_dnf_kernel", "occluded_dnf_kernel")
    inst_names = ("trace_dnf_inst_kernel", "occluded_dnf_inst_kernel")
    flat_routes = ("trace", "occluded")
    flag_label = "flagship cornell_mesh(6)"
    flag_img, launches = timed_render(flag_label, scene, camera, config,
                                      card, flat_names)
    for name in ("trace", "occluded"):
        if launches[name] <= 0:
            raise SmokeFailure(f"the flagship render launched no {name} "
                               "kernel")
    wave = wavefront_flagship(scene, camera, config, card, flat_names,
                              flat_routes, flag_label, flag_img)
    _, inst_launches = timed_render("instanced_demo", inst_scene,
                                    inst_camera, inst_config, card,
                                    inst_names)
    for name in ("trace_inst", "occluded_inst"):
        if inst_launches[name] <= 0:
            raise SmokeFailure(f"the instanced render launched no {name} "
                               "kernel")
    for name in ("trace", "occluded"):
        if inst_launches[name] != 0:
            raise SmokeFailure(f"the instanced render launched the flat "
                               f"{name} kernel")
    _, lights_launches = timed_render(
        "many_lights_demo", lights_scene, lights_camera, config, card,
        flat_names + ("gather_rows_kernel",))
    if lights_launches["gather_rows"] <= 0:
        raise SmokeFailure("the many-light render launched no gather kernel")
    big_label = f"cornell_mesh({BIG_SUBDIVISIONS})"
    _, big_launches = timed_render(
        big_label, big["scene"], camera, config, card,
        ("trace_paged_dnf_kernel", "occluded_paged_dnf_kernel"))
    for name in ("trace_paged_dnf", "occluded_paged_dnf"):
        if big_launches[name] <= 0:
            raise SmokeFailure(f"the {big_label} render launched no {name} "
                               "kernel")
    for name in ("trace", "occluded"):
        if big_launches[name] != 0:
            raise SmokeFailure(f"the {big_label} render launched the flat "
                               f"{name} kernel")
    # The tree route bins its rays (config.ray_sort, the JAX default).
    tree_label = f"{big_label} unpaged (tree walks, binned)"
    if not config.ray_sort:
        raise SmokeFailure("the renders do not sort their rays")
    _, tree_launches = timed_render(
        tree_label, tree_scene, camera, config, card,
        ("trace_tree_kernel", "occluded_tree_kernel"))
    for name in ("trace_tree", "occluded_tree"):
        if tree_launches[name] <= 0:
            raise SmokeFailure(f"the tree-route render launched no {name} "
                               "kernel")
    for name in ("trace", "occluded", "trace_paged_dnf",
                 "occluded_paged_dnf"):
        if tree_launches[name] != 0:
            raise SmokeFailure(f"the tree-route render launched the {name} "
                               "kernel")

    new_launches = {}
    for name in NEW_SCENES:
        sc, _ = new[name]
        _, la = timed_render(name, sc, new_cams[name],
                             config_for(scenes.preferred_background(name)),
                             card, flat_names,
                             min_mean=MIN_MEAN.get(name, 0.05))
        check_routes(name, la, flat_routes)
        new_launches[name] = la
    ris_config = dataclasses.replace(config, nee_candidates=RIS_M)
    ris_label = f"many_lights_demo RIS M={RIS_M}"
    _, ris_launches = timed_render(ris_label, lights_scene, lights_camera,
                                   ris_config, card,
                                   flat_names + ("gather_rows_kernel",))
    check_routes(ris_label, ris_launches, flat_routes + ("gather_rows",))

    # The surface-attribute slice: its three scenes, textured_demo with mips
    # (the retrofit of the JAX CLI's --mips), the textured cornell_mesh(8),
    # then the flagship through the other projections and a moving camera
    # (one timed step each).
    attr_launches = {}
    mips_scene = attr["textured_demo"][0]._replace(
        textures=texture.add_mips(attr["textured_demo"][0].textures))
    if not scene_mod.uses_mips(mips_scene):
        raise SmokeFailure("add_mips gave no mip table")
    attr_renders = [(name, sc, attr_cams[name]) for name, (sc, _) in
                    attr.items()]
    attr_renders.append(("textured_demo mips", mips_scene,
                         attr_cams["textured_demo"]))
    for label, sc, cam in attr_renders:
        _, la = timed_render(label, sc, cam, config, card, flat_names,
                             ranges=attribute_targets())
        check_routes(label, la, flat_routes)
        attr_launches[label] = la
    paged_routes = ("trace_paged_dnf", "occluded_paged_dnf")
    tb_label = f"textured cornell_mesh({BIG_SUBDIVISIONS})"
    _, tb_launches = timed_render(
        tb_label, textured_big["scene"], camera, config, card,
        ("trace_paged_dnf_kernel", "occluded_paged_dnf_kernel"),
        ranges=attribute_targets())
    check_routes(tb_label, tb_launches, paged_routes)
    for case in CAMERA_CASES:
        label = f"flagship {case}"
        _, la = timed_render(
            label, scene, build_pose(camera_variant(cam_cfg, case),
                                     WIDTH / HEIGHT),
            config, card, flat_names, min_mean=MIN_MEAN.get(label, 0.05),
            steps=1)
        check_routes(label, la, flat_routes)
        attr_launches[label] = la
    media_launches = media_renders(media, card, flat_names, flat_routes)
    reference_check()
    bvh_checks(failures)
    if failures:
        raise SmokeFailure("; ".join(failures))

    # The schedulers and post-passes (item 17) and the file loaders (item
    # 18), each phase with its seconds.
    t = time.perf_counter()
    bands, tiles = equal_spp_checks(scene, camera, config)
    sched_launches = scheduler_waves(scene, camera, config, bands, tiles,
                                     results, failures)
    del bands, tiles
    if failures:
        raise SmokeFailure("kernel disagrees with its plain version: "
                           + "; ".join(failures))
    adaptive_res = adaptive_renders(scene, camera, config, card, flat_names)
    post_res = post_passes(scene, camera, cam_cfg, config, card, flag_img,
                           (attr["textured_demo"][0],
                            attr_cams["textured_demo"]))
    examples = example_scenes(card)
    print(f"schedulers, post-passes and example scenes: "
          f"{time.perf_counter() - t:.2f} s", flush=True)

    # The app shell (item 21) and parallel/ (item 19).
    shell_res, accums = app_shell(scene, cam_cfg, config, card)
    parallel_res = parallel_phase(scene, cam_cfg, config, card, accums)
    del accums

    phase("check")
    for name in NEW_SCENES:
        sc, cc = new[name]
        check_routes(f"small {name}", small_render_check(
            name, sc, sc, cc, scenes.preferred_background(name)),
            flat_routes)
    check_routes(f"small {ris_label}", small_render_check(
        ris_label, lights_scene, lights_scene._replace(
            lights=lights_scene.lights._replace(packed=None)),
        lights_cam_cfg, "black", nee_candidates=RIS_M),
        flat_routes + ("gather_rows",))
    del new
    for label, sc, _ in attr_renders:
        cc = attr[label.split()[0]][1]
        check_routes(f"small {label}",
                     small_render_check(label, sc, sc, cc, "black"),
                     flat_routes)
    small_scene, _ = scenes.cornell_mesh(3, device=DEVICE)
    small_render_check("cornell_mesh(3)", small_scene, small_scene, cam_cfg,
                       "black")
    for case in CAMERA_CASES:
        check_routes(f"small {case}", small_render_check(
            f"cornell_mesh(3) {case}", small_scene, small_scene,
            camera_variant(cam_cfg, case), "black"), flat_routes)
    textured_small = scenes.textured_cornell_mesh_builder(3).build(
        DEVICE, page_clusters=16)
    check_routes("small textured paged", small_render_check(
        "textured cornell_mesh(3) paged by 16", textured_small,
        textured_small, cam_cfg, "black"), paged_routes)
    inst_attr = attr_instanced_scene()
    attr_inst_launches = small_render_check(
        "instanced field over a textured ground", inst_attr, inst_attr,
        inst_cam_cfg, inst_config.background)
    check_routes("small instanced attributes", attr_inst_launches,
                 ("trace_inst", "occluded_inst"))
    small_inst, _ = scenes.instanced_demo(grid=6, subdivisions=2,
                                          device=DEVICE)
    small_render_check("instanced_demo(6, 2)", small_inst, small_inst,
                       inst_cam_cfg, inst_config.background)
    # The many-light scene's plain route also leaves the gather kernel: a
    # table without its packed rows indexes each column by the pick.
    unpacked = lights_scene._replace(
        lights=lights_scene.lights._replace(packed=None))
    small_render_check("many_lights_demo", lights_scene, unpacked,
                       lights_cam_cfg, "black")
    paged_small = scenes.cornell_mesh_builder(3).build(DEVICE,
                                                       page_clusters=16)
    small_paged = small_render_check("cornell_mesh(3) paged by 16",
                                     paged_small, paged_small, cam_cfg,
                                     "black")
    if min(small_paged["trace_paged_dnf"],
           small_paged["occluded_paged_dnf"]) <= 0:
        raise SmokeFailure("the small paged render left the paged kernels")
    small_tree = small_render_check(tree_label, tree_scene, tree_scene,
                                    cam_cfg, "black", size=32, depth=4)
    if min(small_tree["trace_tree"], small_tree["occluded_tree"]) <= 0:
        raise SmokeFailure("the small tree-route render left the tree "
                           "kernels")
    for name, (sc, _, cfg, cc) in media.items():
        check_routes(f"small {name}", small_render_check(
            name, sc, sc, cc, cfg.background), flat_routes)
    small_wave = small_wavefront_checks(media, lights_scene, lights_cam_cfg,
                                        inst_cam_cfg, inst_config, cam_cfg)
    del media

    bench = bench_check()
    bench_wave = bench_check("wavefront")

    src = "pathtracing_tpu_torch/csrc/"
    main_inst = {"trace": "static:camera", "occluded": "static:camera_shadow"}
    # Launches per render of 3 timed steps, in the scenes beside the main
    # path's (the flagship for rows 1-2, many_lights_demo for row 3).
    by_scene = {key: {**{name: la[key] for name, la in new_launches.items()},
                      ris_label: ris_launches[key],
                      **{name: la[key] for name, la in attr_launches.items()},
                      "flagship wavefront": wave["launches"][key],
                      **{name: la[key] for name, la in media_launches.items()}}
                for key in ("trace", "occluded", "gather_rows")}
    kernels = [
        kernel_entry(
            "trace_dnf", "trace_dnf_kernel", src + "cluster_trace.cu",
            TPU_SOURCE + ":1153", launches["trace"], results["trace"],
            "camera",
            lambda r: bound_ms(r["needed_evals"], r["rays"],
                               r.get("n_clusters", n_clusters), 52),
            plain="trace_flat_walk_torch", vs_trace_torch="tie contract held",
            design=WALK_DESIGN + " over the flat set's tree; table "
            "normal and material", launches_by_scene=by_scene["trace"]),
        kernel_entry(
            "occluded_dnf", "occluded_dnf_kernel", src + "cluster_trace.cu",
            TPU_SOURCE + ":1266", launches["occluded"], results["occluded"],
            "camera_shadow",
            lambda r: bound_ms(r["needed_evals"], r["rays"],
                               r.get("n_clusters", n_clusters), 29),
            plain="occluded_tree_torch", vs_occluded_torch="equal",
            design=WALK_DESIGN + " over the flat set's tree, any hit",
            launches_by_scene=by_scene["occluded"]),
    ]
    inst_designs = {
        "trace": "two-level sweep: placement boxes culled first, "
                 "warp-cooperative pairs (warp_closest_group)",
        "occluded": "two-level sweep: placement boxes culled first, "
                    "warp-cooperative pairs (warp_any_group), a lane "
                    "retired at its first occluder",
    }
    for key, name, line, ray_bytes in (
        ("trace", "trace_dnf_inst", 1836, 52),
        ("occluded", "occluded_dnf_inst", 1855, 29),
    ):
        # Each wave's bound follows its variant: motion waves count the
        # per-pair inverse and the shutter times.
        kernels.append(kernel_entry(
            name, name + "_kernel", src + "cluster_trace_inst.cu",
            f"{TPU_SOURCE}:{line}", inst_launches[key + "_inst"],
            inst_results[key], main_inst[key],
            lambda r, rb=ray_bytes: bound_ms(
                r["needed_evals"], r["rays"], n_proto, rb, n_exp=n_exp,
                motion=r["motion"]),
            design=inst_designs[key]))
    kernels.append({
        "name": "gather_rows", "route": "cuda", "source": src + "pgather.cu",
        "kernel": "gather_rows_kernel",
        "replaces": "pathtracing_tpu/ops/pgather.py:69",
        "launches": lights_launches["gather_rows"],
        "max_abs_err": gather_res["max_abs_err"], "ms": gather_res["ms"],
        "plain_ms": gather_res["plain_ms"],
        "bound_ms": gather_res["bound_ms"], "bound_by": "bytes",
        "library_ms": gather_res["library_ms"],
        "library": "torch.index_select", "shape": gather_res["shape"],
        "bytes": gather_res["bytes"], "vs_plain": "agree",
        "max_abs_err_ris": ris_res["max_abs_err"],
        "waves": {name: {k: r[k] for k in ("shape", "ms", "plain_ms",
                                             "library_ms", "bound_ms",
                                             "bytes", "mismatches")}
                  for name, r in (("pick", gather_res),
                                  ("ris_candidates", ris_res))},
        "launches_by_scene": by_scene["gather_rows"],
    })
    for name, waves in textured_big["results"].items():
        big["results"][name].update(waves)
    kernels += big_entries(big, big_launches, tree_launches, {
        key: {big_label: big_launches[key], tb_label: tb_launches[key]}
        for key in paged_routes})
    kernels += field
    # The launch counters' names of rows 1-6 and the small wavefront
    # renders that drive them.
    counter = {"trace_dnf": "trace", "occluded_dnf": "occluded",
               "gather_rows": "gather_rows", "trace_dnf_inst": "trace_inst",
               "occluded_dnf_inst": "occluded_inst",
               "trace_paged_dnf": "trace_paged_dnf",
               "occluded_paged_dnf": "occluded_paged_dnf"}
    for entry in kernels:
        if entry["name"] in ("trace_dnf_inst", "occluded_dnf_inst"):
            key = entry["name"].replace("_dnf", "")
            entry["launches_small_attribute_render"] = attr_inst_launches[key]
        if entry["name"] in counter:
            entry["launches_small_wavefront"] = {
                label: la[counter[entry["name"]]]
                for label, la in small_wave.items()
                if la[counter[entry["name"]]]}
        if entry["name"] in binning:
            entry["binning_ab"] = binning[entry["name"]]
        if entry["name"] in ("trace_dnf", "occluded_dnf"):
            entry["wavefront_vs_megakernel"] = {
                k: v for k, v in wave.items() if k != "launches"}
            key = counter[entry["name"]]
            entry["launches_scheduler_wave"] = {
                mode: la[key] for mode, la in sched_launches.items()}
            entry["launches_adaptive_render"] = {
                label: res["launches"].get(key, 0)
                for label, res in adaptive_res.items() if "launches" in res}
            entry["launches_example_scenes"] = {
                name: res["launches"].get(key, 0)
                for name, res in examples.items()
                if res["launches"].get(key)}
            entry["launches_app_shell"] = {
                label: res["launches"].get(key, 0) for label, res in (
                    ("flagship", shell_res["flagship"]),
                    ("tiles_fault", shell_res["tiles_fault"]),
                    *shell_res["branches"].items())}
            entry["launches_parallel"] = {
                label: parallel_res[label]["launches"].get(key, 0)
                for label in ("world1", "adaptive")}
    for entry in kernels:
        entry["ptxas"] = {k: v for k, v in ptxas.items()
                          if k.split("<")[0] == entry["kernel"]}
        if not entry["ptxas"]:
            raise SmokeFailure(f"no ptxas -v report for {entry['kernel']}")
    print("post-passes " + json.dumps({k: v for k, v in post_res.items()
                                       if k != "aov"}), flush=True)
    print("bench " + json.dumps(bench), flush=True)
    print("bench wavefront " + json.dumps(bench_wave), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print("rng " + json.dumps(rng_res), flush=True)
    print(card, flush=True)
    return {"ok": True, "device": {"platform": "gpu", "kind": kind,
                                   "count": count}}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "pathtracing_tpu_torch")):
        print("chip_smoke: the pathtracing_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 1
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        result = run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
