"""Stable ray-binning permutation (the JAX package's ``ops/binning.py``,
as far as the megakernel's live-first compaction needs it)."""

from __future__ import annotations

import torch


def binning_perm(bins):
    """Stable permutation grouping equal bins: ``x[perm]`` groups them in
    bin order, keeping the original order within a bin; ``y[inv]``
    restores the original order of ``y = x[perm]``. ``bins``: (N,) ints.
    Equal to the JAX package's counting-sort permutation, which is the
    unique stable one."""
    perm = torch.sort(bins, stable=True).indices
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device,
                             dtype=perm.dtype)
    return perm, inv
