"""Device time of the traversal kernels (``profiling.TRAVERSAL_KERNEL``:
the port's ``csrc/cluster_trace*.cu``) in the profiled frames or rounds,
per million pixel samples: ms."""

PROFILE_UNITS = 3


def read(run):
    p = run.get("profile")
    if not p or not p["traversal"]["launches"]:
        return None
    return p["traversal"]["s"] * 1e3 / (p["samples"] / 1e6)
