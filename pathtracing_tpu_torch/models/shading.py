"""Per-bounce shading core (the JAX package's ``models/shading.py``).

One bounce = batched closest-hit query -> background/emissive
accumulation (MIS-weighted) -> next-event estimation with a shadow ray ->
branchless BSDF scatter -> Russian roulette. The random draws are the JAX
package's threefry streams, bit for bit (``ops.rng``), so both packages
follow the same paths for the same (pixel, sample, bounce) counters.

Ported branches: scenes without fog, volumes, subsurface media,
absorbing media, environment maps, delta lights, textures, mip cones or
anisotropic materials, and ``nee_candidates == 1``. Every other branch
raises ``NotImplementedError`` naming the ROADMAP queue-A item that
ports it.
"""

from __future__ import annotations

import torch

from pathtracing_tpu_torch.models import scene as scene_mod
from pathtracing_tpu_torch.ops import camera as camera_ops
from pathtracing_tpu_torch.ops import lights as lights_ops
from pathtracing_tpu_torch.ops import linalg, materials, rng

INV_PI = 0.3183098861837907


def background_radiance(direction, mode: str):
    """Environment lookup for escaped rays."""
    shape = direction.shape[:-1] + (3,)
    if mode == "black":
        return torch.zeros(shape, dtype=torch.float32, device=direction.device)
    if mode == "white":
        return torch.ones(shape, dtype=torch.float32, device=direction.device)
    if mode == "gradient":
        # White (1, 1, 1) straight down to blue (0.5, 0.7, 1) straight up,
        # per channel with Python scalars: a color tensor made on the host
        # here would cost a blocking copy to the card per bounce.
        t = 0.5 * (direction[..., 1] + 1.0)
        s = 1.0 - t
        return torch.stack([s + t * 0.5, s + t * 0.7, s + t], dim=-1)
    if mode == "uv":
        return torch.stack([direction[..., 0], direction[..., 1],
                            torch.zeros_like(direction[..., 0])], dim=-1)
    raise ValueError(f"unknown background mode: {mode}")


def _uniforms(kd, tag: int, n: int):
    """Uniforms of stream ``tag`` at this bounce; ``kd`` is the per-path
    key with the bounce already folded in (``rng.stream_key`` split in
    two so the bounce fold is shared by every stream)."""
    return rng.uniform(rng.fold_in(kd, tag), n)


def bounce_batch(scene, o, d, keys, depth: int, radiance, throughput,
                 active, rr_start_depth, background: str, traversal: str,
                 nee: bool = False, prev_pdf=None, prev_nee=None,
                 ld_nee=None, ld_scatter=None, nee_candidates: int = 1,
                 return_shadow_count: bool = False, time=None):
    """One bounce for a whole (R,) ray batch (``depth`` an int: the
    megakernel's bounce index). ``keys`` are the per-path keys
    (``camera_sample``); ``ld_nee`` ((R, 3)) / ``ld_scatter`` ((R, 2))
    optionally replace the first vertex's NEE and scatter draws with the
    precomputed low-discrepancy ones; ``time`` ((R,), scenes with
    motion-blurred instances) is the per-path shutter time, passed to the
    closest-hit and the shadow query. Returns (radiance, throughput, o, d,
    active, prev_pdf, prev_nee), plus the number of shadow rays traced
    (an int64 0-d tensor) with ``return_shadow_count``."""
    if nee_candidates != 1:
        raise NotImplementedError(
            "RIS light picks (nee_candidates > 1) are not ported yet "
            "(ROADMAP queue A item 11)"
        )
    if not isinstance(depth, int):
        raise NotImplementedError(
            "per-ray depth counters (the wavefront engine) are not ported "
            "yet (ROADMAP queue A item 13)"
        )
    r = o.shape[0]
    if prev_pdf is None:
        prev_pdf = torch.zeros(r, dtype=torch.float32, device=o.device)
    if prev_nee is None:
        prev_nee = torch.zeros(r, dtype=torch.bool, device=o.device)
    kd = rng.fold_in(keys, depth)
    first = depth == 0

    hit = scene_mod.intersect_batch(scene, o, d, traversal, active=active,
                                    time=time)

    env = background_radiance(d, background)
    escaped = active & ~hit.valid
    radiance = radiance + torch.where(escaped[:, None], throughput * env, 0.0)

    mtype, alb, par, emit = materials.gather(scene.material_table, hit.mat_id)
    alb = materials.effective_albedo(mtype, alb, par, emit, hit.position)
    emit = materials.effective_emission(mtype, emit)
    metal_col = cc_col = None
    if scene.mat_metallic is not None:
        # Principled columns, gathered only by scenes that carry them.
        safe_id = torch.clamp(hit.mat_id, 0,
                              scene.mat_metallic.shape[0] - 1).long()
        metal_col = scene.mat_metallic[safe_id]
        if scene.mat_clearcoat is not None:
            cc_col = scene.mat_clearcoat[safe_id]
    live = active & hit.valid

    nee_on = nee and scene.lights is not None
    emit_w = torch.ones(r, dtype=torch.float32, device=o.device)
    if nee_on:
        # MIS: a BSDF-sampled hit on a light is the "other estimator" of the
        # direct light the previous vertex already sampled.
        total_power = scene.lights.total_power
        cos_l = torch.abs(linalg.dot(d, hit.normal))
        pdf_l = (hit.t * hit.t * linalg.luminance(emit)
                 / (cos_l * total_power + 1e-20))
        w = prev_pdf ** 2 / (prev_pdf ** 2 + pdf_l ** 2 + 1e-30)
        is_light = hit.valid & (torch.amax(emit, dim=-1) > 0.0)
        emit_w = torch.where(prev_nee & is_light & (total_power > 0.0), w, 1.0)
    radiance = radiance + torch.where(
        live[:, None], throughput * emit * emit_w[:, None], 0.0
    )

    nee_lobe = materials.is_nee_type(mtype)
    n_shadow = torch.zeros((), dtype=torch.int64, device=o.device)

    if nee_on:
        if ld_nee is not None and first:
            ul = ld_nee
        else:
            ul = _uniforms(kd, rng.STREAM_NEE, 3)
        o_nee = hit.position
        lp, ln, lemit, pdf_sa = lights_ops.sample_solid_angle(
            scene.lights, ul, o_nee
        )
        wi_vec = lp - o_nee
        dist2 = linalg.dot(wi_vec, wi_vec)
        dist = torch.sqrt(torch.clamp(dist2, min=1e-12))
        wi = wi_vec / dist[:, None]
        cos_s = linalg.dot(hit.normal, wi)
        cos_l = torch.abs(linalg.dot(ln, wi))
        total_power = scene.lights.total_power
        cand = (live & nee_lobe & (cos_s > 1e-6) & (cos_l > 1e-6)
                & (dist2 > 1e-8) & (total_power > 0.0))
        t_shadow = dist * (1.0 - 1e-3)
        occluded = scene_mod.occluded_batch(
            scene, o_nee, wi, t_shadow, traversal, active=cand, time=time
        )
        vis = cand & ~occluded
        n_shadow = cand.sum()

        # The finite-pdf lobe toward the light: GGX eval for GGX hits,
        # the two- or three-lobe sum with its mixture pdf for principled
        # hits, Lambertian otherwise.
        is_g = mtype == materials.TYPE_GGX
        f_g, pdf_g = materials.ggx_eval(alb, par, hit.normal, -d, wi)
        f_lobe = torch.where(is_g[:, None], f_g, alb * INV_PI)
        pdf_b = torch.where(is_g, pdf_g, cos_s * INV_PI)
        if metal_col is not None:
            is_pr = mtype == materials.TYPE_PRINCIPLED
            f_p, pdf_p = materials.principled_eval(
                alb, metal_col, par, hit.normal, -d, wi, clearcoat=cc_col)
            f_lobe = torch.where(is_pr[:, None], f_p, f_lobe)
            pdf_b = torch.where(is_pr, pdf_p, pdf_b)

        pdf_l = dist2 * linalg.luminance(lemit) / (cos_l * total_power
                                                   + 1e-20)
        w = pdf_l ** 2 / (pdf_l ** 2 + pdf_b ** 2 + 1e-30)
        scale = cos_s / torch.clamp(pdf_sa, min=1e-20) * w
        contrib = throughput * f_lobe * lemit * scale[:, None]
        radiance = radiance + torch.where(vis[:, None], contrib, 0.0)

    u = _uniforms(kd, rng.STREAM_SCATTER, 5)
    if ld_scatter is not None and first:
        u = torch.cat([ld_scatter, u[:, 2:]], dim=1)
    d_out, atten, scattered, scatter_pdf = materials.scatter(
        mtype, alb, par, emit, hit.normal, d, hit.front, u,
        metallic=metal_col, clearcoat=cc_col,
    )
    throughput = throughput * torch.where(live[:, None], atten, 1.0)
    active = live & scattered

    if depth >= rr_start_depth:
        # Counter-based streams: skipping this draw at shallow depths
        # changes no other stream.
        rr_u = _uniforms(kd, rng.STREAM_RR, None)
        p_continue = torch.clamp(torch.amax(throughput, dim=-1), 0.05, 1.0)
        survive = rr_u < p_continue
        throughput = torch.where(survive[:, None],
                                 throughput / p_continue[:, None], throughput)
        active = active & survive

    o = hit.position
    d = torch.where(active[:, None], d_out, d)
    prev_pdf = torch.clamp(scatter_pdf, min=1e-6)
    prev_nee = live & nee_lobe
    out = (radiance, throughput, o, d, active, prev_pdf, prev_nee)
    return out + (n_shadow,) if return_shadow_count else out


def camera_sample(camera, config, seed, pixel_index, sample_index):
    """Primary rays for a batch of (pixel, sample) pairs. Returns (keys,
    origin, direction); the keys are the per-path base keys every bounce
    stream derives from."""
    h, w = config.height, config.width
    x = (pixel_index % w).to(torch.float32)
    # Film t runs bottom→top; image row 0 is the top.
    y = (h - 1 - pixel_index // w).to(torch.float32)
    k = rng.pixel_sample_key(seed, pixel_index, sample_index)
    if config.sampler == "ld":
        j0, j1 = rng.ld_pair(seed, pixel_index, sample_index,
                             rng.STREAM_PIXEL_JITTER)
        l0, l1 = rng.ld_pair(seed, pixel_index, sample_index, rng.STREAM_LENS)
    else:
        ju = rng.uniform(rng.stream_key(k, 0, rng.STREAM_PIXEL_JITTER), 2)
        lu = rng.uniform(rng.stream_key(k, 0, rng.STREAM_LENS), 2)
        j0, j1, l0, l1 = ju[:, 0], ju[:, 1], lu[:, 0], lu[:, 1]
    s = (x + j0) / w
    t = (y + j1) / h
    o, d = camera_ops.generate_ray(camera, s, t, l0, l1)
    return k, o, d
