"""Device operations in the profiled frames or rounds, per million pixel
samples they rendered: what the host issues for the work."""

PROFILE_UNITS = 3


def read(run):
    p = run.get("profile")
    if not p or not p["device_ops"]:
        return None
    return p["device_ops"] / (p["samples"] / 1e6)
