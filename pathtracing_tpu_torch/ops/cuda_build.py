"""Build the port's CUDA and host C++ sources at first use and load them
with ctypes.

Every ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``pathtracing_tpu_torch/.build/`` (git-ignored), named by a hash of the
source, the shared headers and the flags, so an edited source rebuilds and
an unchanged one loads at once. ``build_all`` starts one ``nvcc`` per
source, all together. ``--fmad=false`` keeps the kernels' float rounding
equal to the plain torch versions' (no contracted multiply-adds), so the
card-side check against them can be tight. ``ptxas -v`` reports each
kernel's registers, stack and spills; the compiler's output is kept
beside the library (``build_log``).

``csrc/<name>.cpp`` sources are host code (the SAH BVH builder): the host
C++ compiler (``$CXX``, else ``g++``) builds each into the same directory,
named the same way, at first use (``build_host``). Every build writes a
temporary name and renames it, so processes that build at once do not
race.

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
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC")
# No contracted multiply-adds and no host-specific instructions
# (-march=native), so the host library rounds as the NumPy reference does.
HOST_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")

_LOADED = {}
_COMPILED = set()   # libraries this process compiled (the others were cached)


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


def _hashed_path(name: str, files, flags) -> str:
    digest = hashlib.sha256(" ".join(flags).encode())
    for fname in files:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` goes: named by a hash of the
    source, the shared headers (``csrc/*.cuh``) and the flags."""
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return _hashed_path(name, [f"{name}.cu", *headers], NVCC_FLAGS)


def _host_library_path(name: str) -> str:
    """Where the library of the host source ``csrc/<name>.cpp`` goes."""
    return _hashed_path(name, [f"{name}.cpp"], HOST_FLAGS)


def sources():
    """Names of every ``csrc/<name>.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def build_all(names=None):
    """Compile every named source (default: all of ``csrc/``) whose
    library is missing, one ``nvcc`` per source, all started together;
    returns {name: library path}."""
    names = sources() if names is None else list(names)
    outs = {name: _library_path(name) for name in names}
    _compile([([nvcc_path(), *NVCC_FLAGS], os.path.join(CSRC, f"{name}.cu"),
               out) for name, out in outs.items()])
    return outs


def _compile(jobs) -> None:
    """Run each (compiler command, source, library) of ``jobs`` whose
    library is missing, all processes started together; each writes a
    temporary name that is renamed once it is complete, and the
    compiler's output beside it (``<library>.log``)."""
    procs = []
    for cmd, src, out in jobs:
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        procs.append((src, out, tmp, subprocess.Popen(
            [*cmd, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{proc.args[0]} failed for "
                          f"{os.path.relpath(src, _PKG)}:\n{log}")
        else:
            with open(f"{tmp}.log", "w") as f:
                f.write(log)
            os.replace(f"{tmp}.log", f"{out}.log")
            os.replace(tmp, out)
            _COMPILED.add(out)
    if failed:
        raise RuntimeError("\n".join(failed))


def cxx_path() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` or ``c++`` on PATH."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no host C++ compiler ($CXX, g++ or c++ on PATH) "
                       "to build the port's host libraries")


def build_host(name: str) -> str:
    """Compile the host source ``csrc/<name>.cpp`` unless its library
    exists; returns the library's path."""
    out = _host_library_path(name)
    _compile([([cxx_path(), *HOST_FLAGS], os.path.join(CSRC, f"{name}.cpp"),
               out)])
    return out


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library's path."""
    return build_all([name])[name]


def build_log(name: str) -> str:
    """What the compiler printed when it built ``csrc/<name>.cu`` (with
    ``ptxas -v``: each kernel's registers, stack and spills)."""
    with open(_library_path(name) + ".log") as f:
        return f.read()


def compiled_here(name: str) -> bool:
    """Whether this process compiled ``csrc/<name>.cu`` (False: its
    library and ``build_log`` come from an earlier build of the same
    source and flags)."""
    return _library_path(name) in _COMPILED


def load(name: str, signatures, host: bool = False) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (``host``: of
    ``csrc/<name>.cpp``), built first if needed, with
    ``argtypes``/``restype`` set from ``signatures``
    ({function: [ctypes types]}; every function returns an int error
    code, a CUDA error for the kernels)."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_host(name) if host else build(name))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
