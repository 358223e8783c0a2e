"""Seconds from the harness's start to the window's: imports, the CUDA
context, the scene build, the kernels' build or load, and the warm-up."""


def read(run):
    return run["setup_s"]
