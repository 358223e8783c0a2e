"""One run of one cell of the port's benchmark.

    python3 -m ptbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's scene from its configuration, hands it to the
port's ``SceneBuilder`` and warms the traffic's shapes once; the window
then drives the port for ``--seconds``; the check compares what the
window produced with the plain reference. The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``compared``: each number the check compared beside its limit); the last
lines of standard error give the same numbers and limits.

With ``--trace 0`` the metrics are the cell's end-to-end ones, with
``--trace 1`` its per-layer ones, read from a run whose few profiled
frames or rounds are traced by ``torch.profiler`` (nothing is written to
disk). Exits non-zero, printing no result, without a CUDA card (or with
fewer than the cell asks for), and when the process has loaded JAX or
the JAX package."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from ptbench import check, drive, spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pathtracing_tpu", "benchmarks")


def forbidden_modules():
    """Top-level names of loaded modules that a run must not load,
    compared whole (``pathtracing_tpu_torch`` is the port)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides=None, traffic_overrides=None,
             root: str = spec.ROOT, t_start: float = T_START) -> dict:
    """Set up, run the window and check one cell; returns the result
    object (without printing). ``overrides`` and ``traffic_overrides``
    replace keys of the configuration and of the traffic mix (the tests
    shrink a cell to run it on the CPU). Set-up's parts go to standard
    error."""
    import torch

    from pathtracing_tpu_torch.ops.camera import build_camera
    from pathtracing_tpu_torch.utils.config import CameraConfig

    entry = spec.cell(bench, name)
    config = spec.config_file(bench, entry, root)
    traffic = spec.traffic_file(entry, root)
    traffic.update(traffic_overrides or {})
    config.update(overrides or {})
    loop = spec.module("loops", traffic["loop"], root)
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    parts = {"imports": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    sync()
    parts["device_init"] = time.perf_counter() - t0
    scene_mod = spec.module("scenes", config["scene"], root)
    data = scene_mod.scene_data(config)
    t0 = time.perf_counter()
    scene = scene_mod.build_port(data, device)
    sync()
    scene_build_s = parts["scene_build"] = time.perf_counter() - t0
    camera = build_camera(CameraConfig(**data["camera"]),
                          config["width"] / config["height"], device=device)

    per_layer = spec.metrics_of(bench, name, "per_layer")
    readers = {m["name"]: spec.metric_module(m["name"], root)
               for m in spec.metrics_of(bench, name, "per_layer"
                                        if trace else "end_to_end")}
    units = max([getattr(r, "PROFILE_UNITS", 0) for r in readers.values()]
                + [0]) if trace else 0
    cell = drive.Cell(device=device, scene=scene, camera=camera,
                      config=config, traffic=traffic, seed=seed, sync=sync,
                      trace=trace, profile_units=units)
    t0 = time.perf_counter()
    ctx = loop.setup(cell)
    sync()
    parts["warm_up"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    print("ptbench: set-up " + ", ".join(f"{k} {v:.3f} s"
                                         for k, v in parts.items()),
          file=sys.stderr)
    win = loop.window(cell, ctx, seconds)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    answers = loop.answers(cell, ctx)
    triangles = int(scene.tri_v0.shape[0])
    cell.scene = scene = ctx = None
    if on_card:
        torch.cuda.empty_cache()

    record = dict(win, setup_s=setup_s, scene_build_s=scene_build_s,
                  triangles=triangles)
    metrics = {}
    units_of = {m["name"]: m["unit"] for m in bench["end_to_end"] + per_layer}
    for mname, reader in readers.items():
        value = reader.read(record)
        if value is not None:
            metrics[mname] = {"value": value, "unit": units_of[mname]}

    found = forbidden_modules()
    t0 = time.perf_counter()
    ref = check.reference_of(scene_mod, data, config, device)
    numbers = loop.compare(ref, answers, config, traffic, seed)
    sync()
    print(f"ptbench: the check took {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    rows, correct = check.decide(numbers, loop.LIMITS)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": numbers["attempted"],
              "failed": numbers["failed"], "metrics": metrics, "device": dev}
    prof = win.get("profile")
    if trace and prof is not None:
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["top_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["compared"] = {n: {"value": v, "limit": lim}
                          for n, v, lim in rows}
    result["forbidden_modules"] = found
    return result


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    bench = spec.load()
    entry = spec.cell(bench, args.workload)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < entry["chips"]):
        print(f"ptbench: the cell needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (no CPU fallback)", file=sys.stderr)
        return 1
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = result.pop("forbidden_modules")
    if found:
        print(f"ptbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 2
    if "trace_roofline" in result["metrics"]:
        print(f"ptbench: trace_roofline against the published H100 peaks; "
              f"card {power_limit()}", file=sys.stderr)
    for n, row in result["compared"].items():
        print(f"ptbench check: {n} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
