"""Share of the profiled window (host clock, synchronise to synchronise)
in which no operation ran on the device: 100 (1 - busy / window), %."""

PROFILE_UNITS = 3


def read(run):
    p = run.get("profile")
    if not p or not p["device_ops"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
