#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pathtracing_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. device  — the card's name and power limit; TF32 off.
  2. build   — compile the port's CUDA source into the git-ignored build
               directory.
  3. kernels — each hand-written kernel against its plain torch version
               on the card, on the flagship's own waves (1920x1080 camera
               rays, one bounce wave, and the NEE shadow waves of both),
               with every 11th lane dead and a ray count that is not a
               multiple of the block size; then on a random triangle soup
               past 1024 clusters (more than one shared-memory chunk of
               cluster boxes).
  4. render  — the flagship: cornell_mesh(6), 1920x1080, depth 8, NEE
               with MIS, LD sampler, 1 spp per progressive step, seed 0;
               one warm-up step and 3 timed steps through
               ``progressive.render_step``, then ``resolve``. The kernels'
               launch counts are set to 0 just before the timed steps and
               read just after.
  5. check   — the image is finite with a plausible mean, and a small
               render (cornell_mesh(3), 64x64) through the kernels agrees
               with the same render through the plain versions.

It prints one JSON line per kernel result, a ``{"kernels": [...]}`` line,
the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. It imports nothing of JAX. Without a
CUDA device, or without the package beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

DEVICE = "cuda"
WIDTH, HEIGHT, DEPTH = 1920, 1080, 8
TIMED_STEPS = 3
PLAIN_CHUNK = 1 << 18        # rays per chunk of the plain versions
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


def in_chunks(fn, clusters, arrays, stats):
    """Run a plain traversal over PLAIN_CHUNK-ray chunks; sums stats."""
    import torch

    outs = []
    n = arrays[0].shape[0]
    for s in range(0, n, PLAIN_CHUNK):
        st = {}
        outs.append(fn(clusters, *(a[s:s + PLAIN_CHUNK] for a in arrays),
                       stats=st))
        for k, v in st.items():
            stats[k] = stats.get(k, 0) + v
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def kill_lanes(t):
    t = t.clone()
    t[::11] = 0.0
    return t


def make_waves(scene, camera, config):
    """The flagship's first waves at full width: camera rays, the bounce
    wave one shading step makes of them, and the NEE shadow wave of each.
    Returns {name: (origin, direction, cap)} with every 11th lane dead."""
    import torch

    from pathtracing_tpu_torch.models import scene as scene_mod
    from pathtracing_tpu_torch.models import shading
    from pathtracing_tpu_torch.ops import lights, linalg, rng

    n = WIDTH * HEIGHT - 37          # not a multiple of the 128-ray block
    dev = scene.tri_v0.device
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    keys, o0, d0 = shading.camera_sample(camera, config, config.seed, pix, 0)
    big = torch.full((n,), 3.0e38, device=dev)
    ones = torch.ones((n, 3), device=dev)
    out = shading.bounce_batch(
        scene, o0, d0, keys, 0, torch.zeros((n, 3), device=dev), ones,
        torch.ones(n, dtype=torch.bool, device=dev), config.rr_start_depth,
        config.background, "cluster_cuda", nee=True,
    )
    o1, d1, act1 = out[2], out[3], out[4]

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

    all_live = torch.ones(n, dtype=torch.bool, device=dev)
    return {
        "camera": (o0, d0, kill_lanes(big)),
        "bounce": (o1, d1, kill_lanes(torch.where(act1, big, 0.0))),
        "camera_shadow": shadow(o0, d0, all_live, 0),
        "bounce_shadow": shadow(o1, d1, act1, 1),
    }


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


def bound_ms(stats, n_rays, n_clusters, ray_bytes):
    """Least time for a wave: the Woop tests its rays need (each (ray,
    cluster) pair whose box the ray pierces closer than its best hit so
    far, times the cluster's 128 triangles) over the float32 peak, or its
    bytes (rays in, results out, cluster tables once) over HBM bandwidth,
    whichever is larger. The slab tests of the kernel's brute-force box
    sweep are a cost of that algorithm, not of the query, and stay out."""
    ops = stats["cluster_evals"] * CLUSTER_SIZE * TRI_OPS
    table = n_clusters * (BOX_BYTES + WOOP_BYTES + (
        NORMAL_BYTES + MAT_BYTES if ray_bytes > 29 else 0))
    nbytes = n_rays * ray_bytes + table
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), ops, nbytes


def check_trace(scene, wave, clusters=None):
    """Closest-hit kernel vs trace_torch under the tie contract."""
    import torch

    from pathtracing_tpu_torch.ops import cluster_trace as ct

    o, d, t0 = wave
    cl = scene.clusters if clusters is None else clusters
    ct.trace(cl, o, d, t0)                       # warm-up launch
    ms, (tk, sk, nk, mk) = cuda_ms(lambda: ct.trace(cl, o, d, t0),
                                   KERNEL_REPS)
    stats = {}
    plain_ms, (tp, sp, np_, mp) = cuda_ms(
        lambda: in_chunks(ct.trace_torch, cl, (o, d, t0), stats))
    live = t0 > 0
    same_slot = sk == sp
    tie = tk == tp
    t_ok = torch.isclose(tk, tp, rtol=1e-6, atol=0.0) | ~live
    slot_ok = same_slot | tie | ~live
    hit = same_slot & live & (sp >= 0)
    n_err = (nk - np_).abs().amax(dim=1)
    normal_ok = (n_err <= 1e-4) | ~hit
    mat_ok = (mk == mp) | ~hit
    bad = ~(t_ok & slot_ok & normal_ok & mat_ok)
    err = torch.where(live, (tk - tp).abs(), 0.0)
    return {
        "rays": int(o.shape[0]), "live": int(live.sum()),
        "hits": int((sp >= 0).sum()), "mismatches": int(bad.sum()),
        "max_abs_err": float(err.max()),
        "max_normal_err": float(torch.where(hit, n_err, 0.0).max()),
        "ms": ms, "plain_ms": plain_ms, "stats": stats,
    }


def check_occluded(scene, wave, clusters=None):
    """Any-hit kernel vs occluded_torch: occlusion equal."""
    from pathtracing_tpu_torch.ops import cluster_trace as ct

    o, d, cap = wave
    cl = scene.clusters if clusters is None else clusters
    ct.occluded(cl, o, d, cap)                   # warm-up launch
    ms, occ_k = cuda_ms(lambda: ct.occluded(cl, o, d, cap), KERNEL_REPS)
    stats = {}
    plain_ms, occ_p = cuda_ms(
        lambda: in_chunks(ct.occluded_torch, cl, (o, d, cap), stats))
    bad = occ_k != occ_p
    return {
        "rays": int(o.shape[0]), "live": int((cap > 0).sum()),
        "occluded": int(occ_p.sum()), "mismatches": int(bad.sum()),
        "max_abs_err": float(bad.float().max()),
        "ms": ms, "plain_ms": plain_ms, "stats": stats,
    }


def profile_step(step):
    """Device time of one flagship step by kernel, from torch.profiler:
    the two traversal kernels' share, the rest (plain torch: RNG, shading,
    sampling), and the device's busy share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    n_kernels = 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_name[ev.name] = (by_name.get(ev.name, 0.0)
                            + ev.device_time_total / 1e3)
        n_kernels += 1
    if not by_name:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    device_ms = sum(by_name.values())
    ours = {k: sum(v for n, v in by_name.items() if k in n)
            for k in ("trace_dnf_kernel", "occluded_dnf_kernel")}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "wall_ms": wall_ms, "device_ms": device_ms,
        "busy_share": device_ms / wall_ms, "device_ops": n_kernels,
        **{f"{k}_ms": v for k, v in ours.items()},
        "other_ms": device_ms - sum(ours.values()),
        "top": [[n[:60], ms] for n, ms in top],
    }


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


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

    from pathtracing_tpu_torch.models import progressive, scenes
    from pathtracing_tpu_torch.ops import cluster_trace as ct
    from pathtracing_tpu_torch.ops import cuda_build
    from pathtracing_tpu_torch.ops.camera import build_camera
    from pathtracing_tpu_torch.utils.config import RenderConfig

    t = phase("build")
    lib = cuda_build.build("cluster_trace")
    print(f"build: {os.path.relpath(lib, ROOT)} "
          f"({time.perf_counter() - t:.2f} s)", flush=True)

    t = phase("scene")
    scene, cam_cfg = scenes.cornell_mesh(6, device=DEVICE)
    camera = build_camera(cam_cfg, WIDTH / HEIGHT, device=DEVICE)
    n_clusters = scene.clusters.woop.shape[0]
    print(f"cornell_mesh(6): {scene.tri_v0.shape[0]} triangles, "
          f"{n_clusters} clusters ({time.perf_counter() - t:.2f} s)",
          flush=True)
    config = RenderConfig(
        width=WIDTH, height=HEIGHT, samples_per_pixel=TIMED_STEPS + 1,
        max_depth=DEPTH, samples_per_step=1, seed=0, engine="megakernel",
        nee=True, sampler="ld",
    )

    phase("kernels vs plain")
    waves = make_waves(scene, camera, config)
    results = {"trace": {}, "occluded": {}}
    failures = []
    for wname in ("camera", "bounce"):
        res = check_trace(scene, waves[wname])
        results["trace"][wname] = res
        print("trace_dnf " + json.dumps({"wave": wname, **{
            k: v for k, v in res.items() if k != "stats"}}), flush=True)
        if res["mismatches"]:
            failures.append(f"trace_dnf {wname}: {res['mismatches']} rays")
    for wname in ("camera_shadow", "bounce_shadow"):
        res = check_occluded(scene, waves[wname])
        results["occluded"][wname] = res
        print("occluded_dnf " + json.dumps({"wave": wname, **{
            k: v for k, v in res.items() if k != "stats"}}), flush=True)
        if res["mismatches"]:
            failures.append(f"occluded_dnf {wname}: {res['mismatches']} "
                            "rays")
    del waves
    # A scene past one shared-memory chunk of boxes (1024 clusters), which
    # the flagship (938) never reaches: both kernels on a triangle soup.
    soup_cl, soup_waves = make_soup()
    for kname, check, wave in (("trace_dnf", check_trace, "soup"),
                               ("occluded_dnf", check_occluded,
                                "soup_shadow")):
        res = check(None, soup_waves[wave], clusters=soup_cl)
        print(kname + " " + json.dumps({"wave": wave, "clusters": int(
            soup_cl.woop.shape[0]), **{k: v for k, v in res.items()
                                       if k != "stats"}}), flush=True)
        if res["mismatches"]:
            failures.append(f"{kname} {wave}: {res['mismatches']} rays")
    del soup_cl, soup_waves
    if failures:
        raise SmokeFailure("kernel disagrees with its plain version: "
                           + "; ".join(failures))

    t = phase("flagship render")
    state = progressive.init_state(config, device=DEVICE)
    t0 = time.perf_counter()
    state = progressive.render_step(state, scene, camera, config)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    stats = {}
    ct.reset_launches()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        state = progressive.render_step(state, scene, camera, config,
                                        stats=stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ct.LAUNCHES)
    image = progressive.resolve(state)
    segments = int(stats["segments"])
    shadow = int(stats["shadow_segments"])
    mrays = (segments + shadow) / dt / 1e6
    print(json.dumps({
        "render": "cornell_mesh(6) 1920x1080 depth8 megakernel nee ld",
        "warmup_step_s": warm_s, "timed_steps": TIMED_STEPS,
        "step_s": dt / TIMED_STEPS, "segments": segments,
        "shadow_segments": shadow, "mrays_per_s": mrays,
        "launches": launches, "card": card,
    }), flush=True)
    print(f"flagship: {mrays:.4f} Mrays/s ({segments + shadow} segments in "
          f"{dt:.3f} s) on {card}", flush=True)
    for name in ("trace", "occluded"):
        if launches[name] <= 0:
            raise SmokeFailure(f"the flagship render launched no {name} "
                               "kernel")
    print("profile " + json.dumps(profile_step(
        lambda: progressive.render_step(state, scene, camera, config))),
        flush=True)

    phase("check")
    if tuple(image.shape) != (HEIGHT, WIDTH, 3):
        raise SmokeFailure(f"image shape {tuple(image.shape)}")
    if not bool(torch.isfinite(image).all()):
        raise SmokeFailure("image has non-finite values")
    mean = float(image.mean())
    print(f"image mean {mean:.6f}")
    if not 0.05 < mean < 5.0:
        raise SmokeFailure(f"image mean {mean} outside (0.05, 5)")
    small_scene, _ = scenes.cornell_mesh(3, device=DEVICE)
    small_cam = build_camera(cam_cfg, 1.0, device=DEVICE)
    imgs = {}
    for trav in ("cluster_cuda", "cluster_torch"):
        cfg = RenderConfig(width=64, height=64, samples_per_pixel=2,
                           max_depth=DEPTH, seed=0, traversal=trav)
        imgs[trav] = progressive.render_once(small_scene, small_cam, cfg)
    diff = (imgs["cluster_cuda"] - imgs["cluster_torch"]).abs().amax(-1)
    frac = float((diff > 1e-4).float().mean())
    print(f"small render kernels vs plain: max |diff| {float(diff.max()):.3e}"
          f", pixels over 1e-4: {frac:.4%}", flush=True)
    # Both routes compute the same t bit for bit (--fmad=false), so only a
    # tie resolved to another triangle can part two paths.
    if frac > 0.005:
        raise SmokeFailure("small render through the kernels disagrees with "
                           "the plain versions")

    kernels = []
    for name, src_fn, replaces, waves_used, ray_bytes in (
        ("trace_dnf", "trace_dnf_kernel",
         "pathtracing_tpu/ops/cluster_trace.py:1153", ("camera", "bounce"),
         52),
        ("occluded_dnf", "occluded_dnf_kernel",
         "pathtracing_tpu/ops/cluster_trace.py:1266",
         ("camera_shadow", "bounce_shadow"), 29),
    ):
        key = "trace" if name == "trace_dnf" else "occluded"
        main = results[key][waves_used[0]]
        b_ms, b_by, ops, nbytes = bound_ms(main["stats"], main["rays"],
                                           n_clusters, ray_bytes)
        per_wave = {}
        for w in waves_used:
            r = results[key][w]
            wb, wby, _, _ = bound_ms(r["stats"], r["rays"], n_clusters,
                                     ray_bytes)
            per_wave[w] = {"ms": r["ms"], "plain_ms": r["plain_ms"],
                           "bound_ms": wb, "bound_by": wby,
                           "mismatches": r["mismatches"], "rays": r["rays"],
                           **r["stats"]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pathtracing_tpu_torch/csrc/cluster_trace.cu",
            "kernel": src_fn,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": max(results[key][w]["max_abs_err"]
                               for w in waves_used),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "wave": waves_used[0], "ops": ops, "bytes": nbytes,
            "slab_tests": main["stats"]["slab_tests"],
            "vs_plain": "agree", "waves": per_wave,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
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
