"""The yardstick of the traversal kernels: published peaks of the card and
the least work a closest-hit or any-hit query needs, whatever traversal,
tree or page layout implements it.

A query's least time is the larger of two bounds:

* bytes: each live ray read once (origin, direction, t bound: 28 B) and
  its result written once (closest hit: t, slot, normal, material, 24 B;
  any hit: one flag byte), plus the scene's triangles (v0, e1, e2: 36 B
  each) read once per launch, over the HBM bandwidth;
* operations: one ray-triangle test per live ray (``TEST_FLOPS`` float32
  operations: the Woop transform of origin and direction, the
  division and the barycentric compares), over the float32 peak outside
  the tensor cores.

Both depend on the rays and the scene alone, so a later change to the
kernels' trees or pages cannot move the bound."""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense, at the full 700 W power limit).
PEAK_FLOPS_F32 = 67.0e12
PEAK_BYTES_S = 3.35e12

RAY_IN_BYTES = 28
CLOSEST_OUT_BYTES = 24
ANY_OUT_BYTES = 1
TRIANGLE_BYTES = 36
TEST_FLOPS = 48


def least_seconds(closest_rays: int, any_rays: int, launches: int,
                  triangles: int) -> dict:
    """Least time of ``launches`` traversal queries that together traced
    ``closest_rays`` live closest-hit rays and ``any_rays`` live shadow
    rays over a scene of ``triangles``: {"bytes_s", "flops_s", "s",
    "bound"}."""
    nbytes = (closest_rays * (RAY_IN_BYTES + CLOSEST_OUT_BYTES)
              + any_rays * (RAY_IN_BYTES + ANY_OUT_BYTES)
              + launches * triangles * TRIANGLE_BYTES)
    flops = (closest_rays + any_rays) * TEST_FLOPS
    bytes_s = nbytes / PEAK_BYTES_S
    flops_s = flops / PEAK_FLOPS_F32
    return {"bytes_s": bytes_s, "flops_s": flops_s,
            "s": max(bytes_s, flops_s),
            "bound": "bytes" if bytes_s >= flops_s else "operations"}
