"""Build the port's CUDA sources at first use and load them with ctypes.

Every ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``pathtracing_tpu_torch/.build/`` (git-ignored), named by a hash of the
source, the shared headers and the flags, so an edited source rebuilds and
an unchanged one loads at once. ``build_all`` starts one ``nvcc`` per
source, all together. ``--fmad=false`` keeps the kernels' float rounding
equal to the plain torch versions' (no contracted multiply-adds), so the
card-side check against them can be tight.

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


def _library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` goes: named by a hash of the
    source, the shared headers (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def sources():
    """Names of every ``csrc/<name>.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def build_all(names=None):
    """Compile every named source (default: all of ``csrc/``) whose
    library is missing, one ``nvcc`` per source, all started together;
    returns {name: library path}."""
    names = sources() if names is None else list(names)
    outs = {name: _library_path(name) for name in names}
    procs = []
    for name, out in outs.items():
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        src = os.path.join(CSRC, f"{name}.cu")
        procs.append((name, out, tmp, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library's path."""
    return build_all([name])[name]


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
