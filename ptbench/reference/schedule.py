"""The tile scheduler's greedy rule, written again from its definition
(plain torch): a tile's score is the expected drop of the image's squared
error per sample, sum over its pixels and channels of s^2 / (n (n + 1))
with s^2 the unbiased per-channel sample variance and n its samples;
tiles with fewer than 2 samples score 3e38 - n (breadth first). A round
renders the K best."""

from __future__ import annotations

import torch

EXPLORE = 3.0e38


def tile_scores(accum, m2, tile_spp):
    """(T,) scores of a tile state: ``accum`` and ``m2`` (T, t, t, 3) sums
    of the samples and of their squares, ``tile_spp`` (T,)."""
    n = torch.clamp(tile_spp, min=1).to(torch.float32)
    n4 = n[:, None, None, None]
    mean = accum / n4
    var1 = torch.clamp(m2 / n4 - mean * mean, min=0.0) * (
        n / torch.clamp(n - 1.0, min=1.0))[:, None, None, None]
    score = var1.sum(dim=(1, 2, 3)) / (n * (n + 1.0))
    return torch.where(tile_spp < 2, EXPLORE - tile_spp.to(torch.float32),
                       score)


def picks_missed(accum, m2, tile_spp, next_spp, k: int,
                 tie_rtol: float = 1e-5) -> int:
    """How many of the K best tiles of a state were not rendered in the
    round that follows it (``next_spp`` is the tile spp some rounds
    later). A tile whose score ties the K-th best within ``tie_rtol`` may
    lose the tie to another: it is not counted."""
    scores = tile_scores(accum, m2, tile_spp)
    order = torch.sort(scores, descending=True, stable=True).indices
    best = order[:k]
    kth = scores[order[k - 1]]
    rendered = next_spp[best] > tile_spp[best]
    near_tie = torch.abs(scores[best] - kth) <= tie_rtol * torch.abs(kth)
    return int((~rendered & ~near_tie).sum())
