"""Row gather (the JAX package's ``ops/pgather.py``): a CUDA kernel for
Hopper plus its plain torch version.

  gather_rows(table, idx) -> (N, W)

fetches ``table[clamp(idx, 0, L-1)]`` — ``(L, W)`` float32 rows by an
``(N,)`` integer index — as an exact copy. The many-light NEE pick uses it
to fetch one packed light row per ray (``ops.lights``).

``gather_rows`` dispatches on the table's device: a CPU tensor takes the
plain version (``gather_rows_torch``: ``torch.index_select`` on the
clamped index), a CUDA tensor launches ``gather_rows_kernel`` of
``csrc/pgather.cu`` or raises. Each launch adds one to ``LAUNCHES``. The
TPU kernel's 8 MB table ceiling and its transposed, lane-padded layout are
not carried over: any ``L >= 1``, ``W >= 1`` and ``N`` are taken.
"""

from __future__ import annotations

import ctypes

import torch

from pathtracing_tpu_torch.ops import cuda_build

# Launch count of the CUDA kernel (a run sets it to 0 before the path it
# wants to account for and reads it after).
LAUNCHES = {"gather_rows": 0}

_INDEX_DTYPES = (torch.int32, torch.int64)


def reset_launches() -> None:
    LAUNCHES["gather_rows"] = 0


def gather_rows_torch(table, idx):
    """Plain version: ``index_select`` on the clamped index."""
    safe = torch.clamp(idx, 0, table.shape[0] - 1)
    return torch.index_select(table, 0, safe)


_P = ctypes.c_void_p
_SIGNATURES = {
    # table, idx, idx_is_64, n_rows, width, n, out, stream
    "ptpu_gather_rows": [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.c_longlong, _P, _P],
}


def gather_rows(table, idx):
    """``table[clamp(idx, 0, L-1)]`` (see the module contract). A CPU table
    takes ``gather_rows_torch``; a CUDA table launches
    ``gather_rows_kernel``."""
    if table.dim() != 2 or table.shape[0] < 1 or table.shape[1] < 1:
        raise ValueError("table must be (L, W) with L, W >= 1, got "
                         f"{tuple(table.shape)}")
    if idx.dim() != 1 or idx.dtype not in _INDEX_DTYPES:
        raise TypeError("idx must be a 1-d int32 or int64 tensor, got "
                        f"{idx.dtype} {tuple(idx.shape)}")
    if idx.device != table.device:
        raise ValueError("table and idx lie on different devices "
                         f"({table.device} vs {idx.device})")
    if table.device.type == "cpu":
        return gather_rows_torch(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"table must be a CUDA tensor, got {table.device}")
    if table.dtype != torch.float32:
        raise TypeError(f"table must be torch.float32, got {table.dtype}")
    n_rows, width = table.shape
    n = idx.shape[0]
    out = torch.empty((n, width), dtype=torch.float32, device=table.device)
    if n == 0:
        return out
    table = table.contiguous()
    idx = idx.contiguous()
    lib = cuda_build.load("pgather", _SIGNATURES)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = lib.ptpu_gather_rows(
        table.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
        n_rows, width, n, out.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError("gather_rows_kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES["gather_rows"] += 1
    return out
