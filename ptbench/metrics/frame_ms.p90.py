"""The 90th percentile, over every frame of the window, of the time from
issuing a frame's step to its 8-bit image being on the host (host clock),
in ms. Linear interpolation between order statistics (numpy's default);
nothing for a loop without frames."""


def percentile(values, q):
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def read(run):
    return percentile(run["frame_ms"], 90.0)
