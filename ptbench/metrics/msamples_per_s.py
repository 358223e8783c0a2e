"""Every pixel sample completed in the window over the window's whole time
(host clock, from the window's start to the end of its last frame or
round): Msamples/s. A progressive frame counts width x height samples per
spp, an adaptive round the tile samples it spent."""


def read(run):
    return run["samples"] / run["window_s"] / 1e6
