"""Port parity for the row gather: ``ops.pgather.gather_rows`` against
``jnp.take`` and against the JAX package's Pallas gather kernel in
interpret mode, on the same numpy tables and indices.

Tolerance: none. A gather copies rows, so every backend must agree bit for
bit, including for indices below 0 and past the table (clamped to
[0, L-1]). On CPU tensors the wrapper takes its plain version
(``torch.index_select``); the CUDA kernel is held against the same plain
version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.ops import pgather as jpg
from pathtracing_tpu_torch.ops import pgather as tpg

torch.set_num_threads(2)


def _case(n_rows, width, n, seed=0):
    rs = np.random.default_rng(seed)
    table = rs.standard_normal((n_rows, width)).astype(np.float32)
    # Indices reach below 0 and past the table: both clamp.
    idx = rs.integers(-3, n_rows + 3, n).astype(np.int32)
    return table, idx


SHAPES = [(288, 24, 1000), (1, 24, 5), (129, 3, 77), (300, 24, 1),
          (7, 1, 64)]


@pytest.mark.parametrize("n_rows,width,n", SHAPES)
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_gather_rows_equals_take(n_rows, width, n, idx_dtype):
    table, idx = _case(n_rows, width, n)
    ref = np.asarray(jnp.take(jnp.asarray(table),
                              jnp.clip(jnp.asarray(idx), 0, n_rows - 1),
                              axis=0))
    before = dict(tpg.LAUNCHES)
    out = tpg.gather_rows(torch.as_tensor(table),
                          torch.as_tensor(idx).to(idx_dtype))
    assert out.dtype == torch.float32 and tuple(out.shape) == (n, width)
    assert out.numpy().tobytes() == ref.tobytes()
    assert tpg.LAUNCHES == before           # CPU tensors launch nothing


@pytest.mark.parametrize("n_rows,width,n", [(288, 24, 1000), (129, 3, 77)])
def test_gather_rows_equals_pallas_kernel_interpret(n_rows, width, n):
    table, idx = _case(n_rows, width, n, seed=1)
    ref = np.asarray(jpg.gather_rows(jnp.asarray(table), jnp.asarray(idx),
                                     interpret=True))
    out = tpg.gather_rows(torch.as_tensor(table), torch.as_tensor(idx))
    assert out.numpy().tobytes() == ref.tobytes()
    assert out.numpy().tobytes() == tpg.gather_rows_torch(
        torch.as_tensor(table), torch.as_tensor(idx)).numpy().tobytes()


def test_gather_rows_empty_index():
    table, _ = _case(5, 24, 1)
    out = tpg.gather_rows(torch.as_tensor(table),
                          torch.zeros(0, dtype=torch.int64))
    assert tuple(out.shape) == (0, 24)


@pytest.mark.parametrize("case", ["float_index", "index_2d", "table_1d",
                                  "empty_table", "meta_device",
                                  "device_mismatch"])
def test_gather_rows_refuses(case):
    table = torch.zeros((4, 8))
    idx = torch.zeros(3, dtype=torch.int64)
    calls = {
        "float_index": (TypeError, lambda: tpg.gather_rows(
            table, idx.float())),
        "index_2d": (TypeError, lambda: tpg.gather_rows(table, idx[None])),
        "table_1d": (ValueError, lambda: tpg.gather_rows(table[0], idx)),
        "empty_table": (ValueError, lambda: tpg.gather_rows(table[:0],
                                                            idx)),
        # Neither the CPU nor a CUDA device: no quiet plain version.
        "meta_device": (ValueError, lambda: tpg.gather_rows(
            table.to("meta"), idx.to("meta"))),
        "device_mismatch": (ValueError, lambda: tpg.gather_rows(
            table, idx.to("meta"))),
    }
    exc, fn = calls[case]
    before = dict(tpg.LAUNCHES)
    with pytest.raises(exc):
        fn()
    assert tpg.LAUNCHES == before
