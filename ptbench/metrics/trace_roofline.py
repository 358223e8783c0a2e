"""The traversal kernels' least time (``roofline.least_seconds``: the live
rays and the scene's triangles over the H100's bandwidth, or one test per
live ray over its float32 peak) over their device time in the profiled
frames: %. The live rays are the engine's counts of those frames; nothing
where the loop's entry takes no ``stats``."""

from ptbench import roofline

PROFILE_UNITS = 3


def read(run):
    p = run.get("profile")
    c = p and p.get("counts")
    if not c or "segments" not in c or not p["traversal"]["launches"]:
        return None
    least = roofline.least_seconds(c["segments"], c["shadow_segments"],
                                   p["traversal"]["launches"],
                                   run["triangles"])
    return 100.0 * least["s"] / p["traversal"]["s"]
