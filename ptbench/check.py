"""How ``correct`` is decided: the timed path's own output against the
plain reference (``reference/``), on pixels drawn from the run's seed.

For each sampled pixel the reference traces every sample the program
accumulated there (the same (pixel, sample) paths, from the frozen
streams) and sums them. A pixel's gap is the largest channel difference
of the two sums over the reference's largest channel (at least 0.01 per
sample). Each loop (``loops/<loop>.py``) compares its window's answers by
these gaps, and by what else its layers need, under its own ``LIMITS``:

* ``median_gap``: the median gap over the sampled pixels that the
  reference finds lit (about half of the frame sees the void beside the
  box, where any two renders read 0);
* ``off_share``: the share of all sampled pixels whose gap passes
  ``OFF_GAP`` (paths that left the reference's: a hit, a shadow ray or
  a light pick decided otherwise)."""

from __future__ import annotations

import numpy as np
import torch

from ptbench.reference import pathtrace

OFF_GAP = 1e-3
PATH_CHUNK = 1 << 16
ORDER_PIXELS = 48


def pixel_gaps(prog, ref, spp, floor_per_sample):
    """(P,) gaps of (P, 3) sums holding ``spp`` (P,) samples each."""
    scale = torch.clamp(ref.amax(dim=1),
                        min=floor_per_sample * spp.to(torch.float32))
    return (prog - ref).abs().amax(dim=1) / scale


def gap_numbers(prog, want, spp) -> dict:
    """``median_gap``, ``off_share`` and the pixels ``attempted`` and
    ``failed`` of (P, 3) sums against the reference's ``want``."""
    gaps = pixel_gaps(prog, want, spp, 0.01)
    off = gaps > OFF_GAP
    return {"median_gap": float(gaps[want.amax(dim=1) > 0].median()),
            "off_share": float(off.float().mean()),
            "attempted": int(gaps.numel()), "failed": int(off.sum())}


class Reference:
    """The reference of one scene: geometry, lights in each order, and
    the render settings; sums the paths of (pixel, spp) lists. The
    geometry is the flat one of ``triangles`` unless ``geo`` is given
    (``triangles`` then holds the emitters, with any other base
    triangles)."""

    def __init__(self, data, triangles, config, device,
                 dtype=torch.float32, geo=None):
        v0, e1, e2, mat = triangles
        self.data = data
        self.config = config
        self.geo = geo or pathtrace.prepare(v0, e1, e2, mat, device, dtype)
        self.orders = pathtrace.light_orders(v0, e1, e2, mat,
                                             data["materials"], device, dtype)
        self.light = self.orders[0]
        self.device = device

    def sums(self, seed, pixels, spp, light=None, squares=False, first=0):
        """(P, 3) sums over samples first..first+spp-1 of each pixel (and
        of the squared samples with ``squares``)."""
        light = light or self.light
        c = self.config
        pixels = torch.as_tensor(pixels, device=self.device).long()
        spp = torch.as_tensor(spp, device=self.device).long()
        owner = torch.repeat_interleave(torch.arange(pixels.shape[0],
                                                     device=self.device), spp)
        starts = torch.cumsum(spp, 0) - spp
        sample = (torch.arange(owner.shape[0], device=self.device)
                  - starts[owner] + int(first))
        out = torch.zeros((pixels.shape[0], 3), dtype=torch.float32,
                          device=self.device)
        out2 = torch.zeros_like(out)
        for a in range(0, owner.shape[0], PATH_CHUNK):
            o = owner[a:a + PATH_CHUNK]
            rad = pathtrace.render(
                self.geo, light, self.data["materials"], self.data["camera"],
                c["width"], c["height"], c["max_depth"], seed, pixels[o],
                sample[a:a + PATH_CHUNK])
            out.index_add_(0, o, rad)
            out2.index_add_(0, o, rad * rad)
        return (out, out2) if squares else out

    def pick_order(self, seed, pixels, spp, prog):
        """Keep the light order whose sums the program's follow (the
        program's stored order of the emitters is its own choice)."""
        n = min(ORDER_PIXELS, len(pixels))
        best = None
        for light in self.orders:
            ref = self.sums(seed, pixels[:n], spp[:n], light)
            g = float(pixel_gaps(prog[:n], ref,
                                  torch.as_tensor(spp[:n], device=self.device),
                                  0.01).median())
            if best is None or g < best[0]:
                best = (g, light)
        self.light = best[1]


def reference_of(scene_mod, data, config, device, dtype=torch.float32):
    """The plain reference of a scene: the scene module's own, where it
    brings one (``reference(data, config, device, dtype)``), else the flat
    reference of its ``triangles(data)``."""
    if hasattr(scene_mod, "reference"):
        return scene_mod.reference(data, config, device, dtype=dtype)
    return Reference(data, scene_mod.triangles(data), config, device, dtype)


def sample_pixels(seed: int, n_pixels: int, count: int, salt: int = 0):
    rng = np.random.default_rng([int(seed) & ((1 << 63) - 1), salt])
    return np.sort(rng.choice(n_pixels, size=min(count, n_pixels),
                              replace=False))


def decide(numbers: dict, limits: dict):
    """[(name, value, limit)] and whether every value is within its limit
    (a missing or non-finite value fails)."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= limit
        ok = ok and good
        rows.append((name, v, limit))
    return rows, ok
