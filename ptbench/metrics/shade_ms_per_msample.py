"""Device time of the profiled frames or rounds outside the traversal
kernels and outside the present (plain torch: shading, streams, light and
scatter sampling, the engine's bookkeeping, the scheduler's), per million
pixel samples: ms."""

PROFILE_UNITS = 3


def read(run):
    p = run.get("profile")
    if not p or not p["device_ops"]:
        return None
    total = sum(s for s, _ in p["by_name"].values())
    other = total - p["traversal"]["s"] - p["by_span"].get("present", 0.0)
    return other * 1e3 / (p["samples"] / 1e6)
