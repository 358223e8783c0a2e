"""Build the port's CUDA sources at first use and load them with ctypes.

Every ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``pathtracing_tpu_torch/.build/`` (git-ignored), named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
loads at once. ``--fmad=false`` keeps the kernels' float rounding equal to
the plain torch versions' (no contracted multiply-adds), so the card-side
check against them can be tight.

Nothing is compiled when this module is imported: the CPU test suite
imports every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, ".build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LOADED = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                           "kernels are built on the machine with the card")
    return path


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library's path."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def load(name: str, signatures) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built first if needed),
    with ``argtypes``/``restype`` set from ``signatures``
    ({function: [ctypes types]}; every function returns a CUDA error code
    as int)."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
