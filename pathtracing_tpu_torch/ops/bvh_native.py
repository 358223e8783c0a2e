"""ctypes binding of the host SAH BVH builder ``csrc/bvh_builder.cpp`` (the
port's copy of the JAX package's ``native/bvh_builder.cpp``).

``ops.cuda_build.build_host`` compiles the source with the host C++
compiler at first use into the git-ignored build directory; a library that
cannot be built or loaded raises. The layout is that of
``ops.bvh._build_bvh_numpy``, the reference (see the C++ header comment).
"""

from __future__ import annotations

import ctypes

import numpy as np

from pathtracing_tpu_torch.ops import cuda_build

_F = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    # v0, e1, e2, n, leaf_size, sah_bins, node_min, node_max, node_meta,
    # perm, out_node_count
    "ptpu_build_bvh": [_F, _F, _F, ctypes.c_int64, ctypes.c_int32,
                       ctypes.c_int32, _F, _F,
                       ctypes.POINTER(ctypes.c_int32),
                       ctypes.POINTER(ctypes.c_int64),
                       ctypes.POINTER(ctypes.c_int64)],
}


def build(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, leaf_size: int,
          sah_bins: int):
    """((node_min, node_max, node_meta), perm), as ``_build_bvh_numpy``."""
    lib = cuda_build.load("bvh_builder", _SIGNATURES, host=True)
    n = int(v0.shape[0])
    cap = 2 * max(n, 1)
    v0c, e1c, e2c = (np.ascontiguousarray(a, np.float32) for a in (v0, e1, e2))
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    node_meta = np.empty((cap, 3), np.int32)
    perm = np.empty(n, np.int64)
    count = ctypes.c_int64(0)

    def ptr(a, ty):
        return a.ctypes.data_as(ctypes.POINTER(ty))

    rc = lib.ptpu_build_bvh(
        ptr(v0c, ctypes.c_float), ptr(e1c, ctypes.c_float),
        ptr(e2c, ctypes.c_float), n, leaf_size, sah_bins,
        ptr(node_min, ctypes.c_float), ptr(node_max, ctypes.c_float),
        ptr(node_meta, ctypes.c_int32), ptr(perm, ctypes.c_int64),
        ctypes.byref(count),
    )
    if rc != 0:
        raise RuntimeError(f"ptpu_build_bvh failed with code {rc}")
    m = count.value
    return (node_min[:m].copy(), node_max[:m].copy(),
            node_meta[:m].copy()), perm
