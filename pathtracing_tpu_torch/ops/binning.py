"""Ray binning (the JAX package's ``ops/binning.py``): stable permutations
that group rays by (coarse spatial cell, direction bin), and the two-bin
live-first permutation of the megakernel's compaction.

The JAX package builds its permutation by a counting sort (one-hot,
cumsum, one unique scatter), because the TPU's sort is unusable at pool
sizes. A stable sort gives the same permutation (the stable grouping is
unique), so the port takes ``torch.sort(stable=True)``.
"""

from __future__ import annotations

import torch

N_CELLS = 3   # spatial cells per axis of the single-pass default
N_BINS = (N_CELLS ** 3) * 8  # cells x direction octants = 216

# n_bins -> (cells per axis, direction bins) of ``sort_rays``; direction
# bins are the octant (8) or the octant x the dominant axis (24).
BIN_CONFIGS = {
    216: (3, 8),
    512: (4, 8),
    648: (3, 24),
    1536: (4, 24),
    1728: (6, 8),
    3000: (5, 24),
    5184: (6, 24),
}


def binning_perm(bins, n_bins: int = None):
    """Stable permutation grouping equal bins: ``x[perm]`` groups them in
    bin order, keeping the original order within a bin; ``y[inv]``
    restores the original order of ``y = x[perm]``. ``bins``: (N,) ints in
    [0, ``n_bins``) (the JAX signature's bin count; the sort needs no
    bound). Equal to the JAX package's counting-sort permutation, which
    is the unique stable one."""
    del n_bins
    perm = torch.sort(bins, stable=True).indices
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device,
                             dtype=perm.dtype)
    return perm, inv


def _spatial_bin(origin, scene_lo, scene_hi, cells: int):
    q = torch.clamp(
        (origin - scene_lo) / torch.clamp(scene_hi - scene_lo, min=1e-6)
        * cells, 0.0, cells - 1e-3,
    ).to(torch.int32)
    return (q[:, 0] * cells + q[:, 1]) * cells + q[:, 2]


def _dir_bin(direction, dirs: int):
    octant = ((direction[:, 0] > 0).to(torch.int32) * 4
              + (direction[:, 1] > 0).to(torch.int32) * 2
              + (direction[:, 2] > 0).to(torch.int32))
    if dirs == 8:
        return octant
    if dirs == 24:
        # The octant refined by the dominant |d| axis (the first on ties).
        ax = torch.argmax(torch.abs(direction), dim=1).to(torch.int32)
        return octant * 3 + ax
    raise ValueError(f"unsupported direction bins: {dirs}")


def sort_rays(origin, direction, scene_lo, scene_hi, active,
              n_bins: int = N_BINS):
    """(perm, inv) grouping rays by (spatial cell, direction bin).

    ``n_bins`` must be a key of BIN_CONFIGS. Up to 256 bins this is one
    pass; above, a stable two-pass LSD composition over the (cell, dir)
    key: pass 1 sorts by direction bin, pass 2 by cell. Dead rays sort to
    the back of the last cell."""
    cells, dirs = BIN_CONFIGS[n_bins]
    cell = _spatial_bin(origin, scene_lo, scene_hi, cells)
    db = _dir_bin(direction, dirs)
    n_cell = cells ** 3
    if n_bins <= 256:
        bins = torch.where(active, cell * dirs + db, n_bins - 1)
        return binning_perm(bins, n_bins)
    # Dead rays: the largest composite key in both passes.
    cell = torch.where(active, cell, n_cell - 1)
    db = torch.where(active, db, dirs - 1)
    perm1, pos1 = binning_perm(db, dirs)
    perm2, pos2 = binning_perm(cell[perm1], n_cell)
    # Element i lands at pos2[pos1[i]]; the reading side is perm1[perm2].
    return perm1[perm2], pos2[pos1]


def ray_bin(origin, direction, scene_lo, scene_hi, active):
    """(N,) bin ids: coarse spatial cell x direction octant; dead rays land
    in the last bin (the stable sort keeps them together at the back)."""
    cell = _spatial_bin(origin, scene_lo, scene_hi, N_CELLS)
    octant = _dir_bin(direction, 8)
    return torch.where(active, cell * 8 + octant, N_BINS - 1)
