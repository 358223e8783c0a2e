"""Per-bounce shading core (the JAX package's ``models/shading.py``).

One bounce = batched closest-hit query -> Beer–Lambert absorption over
the segment -> environment/emissive accumulation (MIS-weighted) ->
participating media (fog, a voxel grid, interior scattering: an event
pre-empts the surface) -> next-event estimation with shadow rays (area
lights, optionally by RIS; the environment map; delta lights) ->
branchless BSDF scatter or phase sampling -> Russian roulette -> the
medium handoff at dielectric boundaries. The random draws
are the JAX package's threefry streams, bit for bit (``ops.rng``), so both
packages follow the same paths for the same (pixel, sample, bounce)
counters. Each optional branch runs only for a scene that carries its
data (``mat_absorb``, ``env``, ``delta``, ``mat_param2``, ``mat_disp``,
``mat_aniso``, surface attributes and textures, a mip pyramid) or a config
that asks for it (``nee_candidates > 1``), and draws no stream otherwise,
so every other scene keeps its ops and streams.

The media follow the same rule: fog (``STREAM_FOG``), a voxel grid
(``STREAM_VOL``/``STREAM_VOLT``, ``ops.volume``) and interior scattering
(``STREAM_SSS``) run only for a scene that carries them. ``depth`` is an
int for the megakernel and a per-slot tensor for the wavefront pool; both
draw the same streams for the same counters.
"""

from __future__ import annotations

import numpy as np
import torch

from pathtracing_tpu_torch.models import scene as scene_mod
from pathtracing_tpu_torch.ops import camera as camera_ops
from pathtracing_tpu_torch.ops import envmap as envmap_ops
from pathtracing_tpu_torch.ops import lights as lights_ops
from pathtracing_tpu_torch.ops import linalg, materials, rng
from pathtracing_tpu_torch.ops import sampling as sampling_ops
from pathtracing_tpu_torch.ops import texture as texture_ops
from pathtracing_tpu_torch.ops import volume as volume_ops

INV_PI = 0.3183098861837907
# Distance of the any-hit query toward an environment at infinity.
ENV_SHADOW_T = 1.0e7


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


def _column(col, mat_id):
    """Rows of an optional per-material column for a batch of ids."""
    return col[torch.clamp(mat_id, 0, col.shape[0] - 1).long()]


def _pick_rows(x, j, m: int):
    """Row ``j[i]`` of candidate group ``i`` of ``x`` (R·m, ...)."""
    r = j.shape[0]
    rows = torch.arange(r, device=j.device) * m + j
    return x[rows]


def _ris_pick(scene, ul_all, u_pick, o_nee, normal, lobe, m: int, d,
              medium=None):
    """Talbot RIS over ``m`` power-CDF light candidates per vertex: all
    R·m candidates sampled in one call (gather-mode tables fetch their
    rows through ``pgather.gather_rows``), scored by the unshadowed
    luminance(f·Le)·cosθ per solid angle, one resampled ∝ score. Medium
    vertices (``medium``: (is_med, phase g, albedo), each (R,)) score by
    luminance(Le)·albedo·phase instead. Returns the winner's (point,
    normal, emit), its effective density m·p̂/Σw (inf where no candidate
    scores), ``ris_ok`` and the winner's uniforms; the candidates'
    tensors go out of scope here."""
    r = o_nee.shape[0]
    o_rep = torch.repeat_interleave(o_nee, m, dim=0)
    clp, cln, clemit, cpdf = lights_ops.sample_solid_angle(
        scene.lights, ul_all.reshape(r * m, 3), o_rep)
    cvec = clp - o_rep
    cd2 = torch.clamp(linalg.dot(cvec, cvec), min=1e-12)
    cwi = cvec / torch.sqrt(cd2)[:, None]
    ccos = torch.clamp(
        linalg.dot(torch.repeat_interleave(normal, m, dim=0), cwi), min=0.0)
    # The BSDF belongs in the target: a luminance(Le)·cos target resamples
    # glossy lanes toward lights their lobe cannot see.
    cf_lobe, _ = lobe(cwi, ccos, m)
    target = linalg.luminance(cf_lobe * clemit) * ccos
    if medium is not None:
        is_med, ph_g, alb_med = (torch.repeat_interleave(x, m, dim=0)
                                 for x in medium)
        cph = sampling_ops.hg_phase(
            ph_g, linalg.dot(torch.repeat_interleave(d, m, dim=0), cwi))
        target = torch.where(is_med,
                             linalg.luminance(clemit) * cph * alb_med, target)
    wgt = torch.where(cpdf > 1e-20, target / torch.clamp(cpdf, min=1e-20),
                      0.0).reshape(r, m)
    w_sum = torch.sum(wgt, dim=1)
    cum_w = torch.cumsum(wgt, dim=1)
    j = torch.clamp(torch.sum((u_pick[:, None] * w_sum[:, None]
                               > cum_w).to(torch.int64), dim=1), 0, m - 1)
    p_hat = _pick_rows(target, j, m)
    ris_ok = (w_sum > 0.0) & (p_hat > 0.0)
    # Winner reuse: the candidate pass already sampled the winner's point,
    # normal and emission (a pure function of (u, origin)).
    pdf_sa = torch.where(ris_ok, m * p_hat / torch.clamp(w_sum, min=1e-20),
                         torch.inf)
    return (_pick_rows(clp, j, m), _pick_rows(cln, j, m),
            _pick_rows(clemit, j, m), pdf_sa, ris_ok,
            _pick_rows(ul_all.reshape(r * m, 3), j, m))


def _free_flight(u, sigma):
    """Exponential free-flight distance at rate ``sigma``."""
    return -torch.log1p(-torch.clamp(u, max=1.0 - 1e-7)) / sigma


def bounce_batch(scene, o, d, keys, depth, radiance, throughput, active,
                 rr_start_depth, background: str, traversal: str,
                 nee: bool = False, prev_pdf=None, prev_nee=None,
                 ld_nee=None, ld_scatter=None, nee_candidates: int = 1,
                 return_shadow_count: bool = False, time=None, medium=None,
                 sss=None, cone=None, cone_spread=None,
                 bin_rays: bool = False, counts=None):
    """One bounce for a whole (R,) ray batch. ``depth`` is the bounce index:
    an int (the megakernel: every lane at one depth) or an (R,) integer
    tensor (the wavefront pool: per-slot counters). ``keys`` are the
    per-path keys (``camera_sample``); ``ld_nee`` ((R, 3)) /
    ``ld_scatter`` ((R, 2)) optionally replace the first vertex's NEE and
    scatter draws with the precomputed low-discrepancy ones (under RIS,
    candidate 0's), on the lanes at depth 0; ``time`` ((R,), scenes with
    motion-blurred instances) is the per-path shutter time, passed to the
    closest-hit and the shadow queries. With an int depth the first-vertex
    choice and Russian roulette are Python branches; with a tensor they
    are per-lane selects and masks over the same draws.

    ``bin_rays`` (``RenderConfig.ray_sort``): the closest-hit and shadow
    queries of a scene that walks the cluster tree take their rays in
    (cell, octant) bins; the cluster sweeps (``uses_dnf``) never bin, as
    in the JAX package. The results do not depend on it. ``counts``
    (``cluster_trace.walk_counts``, or None) gets the two-level instanced
    walk's counts of this bounce's queries.

    ``medium`` ((R, 3), scenes with ``mat_absorb``; zeros when None) is
    the per-path interior sigma_a: the segment travelled loses
    exp(−sigma_a·t) of throughput, and the coefficient changes where the
    scatter transmits through a dielectric (entering: the material's row;
    leaving: vacuum). ``sss`` ((R, 2), scenes with ``mat_interior``) is
    the per-path interior scattering row [sigma_s, g], handed over at
    dielectric boundaries the same way: inside, a flight ~ Exp(sigma_s)
    that ends before the boundary is an interior event (weight 1, HG
    phase direction, no NEE: the boundary occludes it). Scenes with
    ``fog`` distance-sample a homogeneous medium (``STREAM_FOG``), scenes
    with ``vol`` delta-track the voxel grid (``ops.volume``): an event
    pre-empts the surface hit, carries the single-scattering albedo,
    samples NEE with the phase as its lobe (MIS against the lights) and
    continues by HG phase sampling; every NEE arm pays the fog's
    exp(−sigma_t·d) or the grid's ratio-tracked transmittance, and an
    emissive grid adds its absorption-weighted emission at the event.
    ``nee_candidates`` M > 1 picks the area light by RIS over M
    candidates (``3M + 1`` uniforms of the NEE stream), still one shadow
    ray per vertex.

    Scenes with surface attributes or textures resolve the shading normal
    and uvs at every hit (``scene.surface_attributes``): the texel scales
    the albedo, and the emission of a textured emitter; a metallic-
    roughness map scales roughness (G) and metallic (B); the shading
    normal replaces the geometric one in every later cosine, frame and
    pdf. NEE toward textured emitters takes the sampled point's texel
    from the same draws (``sample_solid_angle(with_uv=True)``), and both
    MIS arms keep the base emission. ``cone`` ((R,), scenes with a mip
    pyramid) is each path's distance from the camera: with the pixel
    spread ``cone_spread`` (``cone_spread_of``) it gives the texture LOD.

    Returns (radiance, throughput, o, d, active, prev_pdf, prev_nee),
    then ``medium`` for scenes with ``mat_absorb``, ``sss`` for scenes
    with ``mat_interior``, ``cone`` for scenes with a mip pyramid, then
    with ``return_shadow_count`` the number of shadow rays traced
    (area-light, environment and delta waves; an int64 0-d tensor)."""
    per_lane = not isinstance(depth, int)
    r = o.shape[0]
    dev = o.device
    if prev_pdf is None:
        prev_pdf = torch.zeros(r, dtype=torch.float32, device=dev)
    if prev_nee is None:
        prev_nee = torch.zeros(r, dtype=torch.bool, device=dev)
    kd = rng.fold_in(keys, depth)
    # The first vertex: a Python bool for an int depth, a lane mask for
    # per-slot counters.
    first = (depth == 0)[:, None] if per_lane else depth == 0
    # Whether this bounce may take LD draws at all (some lane at depth 0).
    any_first = per_lane or first

    def first_draws(ld, u):
        """The first vertex's LD draws ``ld`` in place of ``u`` (same
        width) where the lane is at depth 0."""
        return torch.where(first, ld, u) if per_lane else ld

    bin_rays = bin_rays and not scene_mod.uses_dnf(scene)
    hit = scene_mod.intersect_batch(scene, o, d, traversal, active=active,
                                    time=time, bin_rays=bin_rays,
                                    counts=counts)

    has_fog = scene.fog is not None
    has_vol = scene.vol is not None
    has_sss = scene.mat_interior is not None
    if has_fog or has_vol or has_sss:
        # A medium event must come before the surface hit (3e38: a miss).
        t_eff = torch.where(hit.valid, hit.t, 3.0e38)
    if has_fog:
        # Homogeneous fog: a free flight against sigma_t; an event before
        # the surface pre-empts it and carries the albedo sigma_s/sigma_t.
        fog_ss, fog_sa, fog_g = scene.fog[0], scene.fog[1], scene.fog[2]
        fog_sigma_t = fog_ss + fog_sa
        fog_albedo = fog_ss / fog_sigma_t
        uf = _uniforms(kd, rng.STREAM_FOG, 3)
        t_fog = _free_flight(uf[:, 0], fog_sigma_t)
        med_event = active & (t_fog < t_eff)
        o_med = o + t_fog[:, None] * d
        d_phase, cos_hg = sampling_ops.hg_sample(d, fog_g, uf[:, 1],
                                                 uf[:, 2])
        p_phase = sampling_ops.hg_phase(fog_g, cos_hg)
    if has_vol:
        # Voxel grid: delta tracking at the per-ray majorant; the albedo
        # is constant, and NEE arms pay ratio-tracked transmittance.
        vol = scene.vol
        vol_event, t_vol, u_ph = volume_ops.sample_distance(
            vol, keys, depth, o, d, t_eff, active)
        o_vol = o + t_vol[:, None] * d
        d_phase_v, cos_v = sampling_ops.hg_sample(d, vol.g, u_ph[:, 0],
                                                  u_ph[:, 1])
        p_phase_v = sampling_ops.hg_phase(vol.g, cos_v)
        vol_albedo = vol.albedo
    if has_sss:
        # Interior scattering: the fog estimator with [sigma_s, g] from the
        # path's own row; lanes in vacuum draw too and never event.
        if sss is None:
            sss = torch.zeros((r, 2), dtype=torch.float32, device=dev)
        sss_sig, sss_g = sss[:, 0], sss[:, 1]
        u_s = _uniforms(kd, rng.STREAM_SSS, 3)
        t_sss = _free_flight(u_s[:, 0], torch.clamp(sss_sig, min=1e-12))
        sss_event = active & (sss_sig > 0.0) & (t_sss < t_eff)
        o_sss = o + t_sss[:, None] * d
        d_phase_s, cos_ps = sampling_ops.hg_sample(d, sss_g, u_s[:, 1],
                                                   u_s[:, 2])
        p_phase_s = sampling_ops.hg_phase(sss_g, cos_ps)

    has_media = scene.mat_absorb is not None
    if has_media:
        if medium is None:
            medium = torch.zeros((r, 3), dtype=torch.float32, device=dev)
        # Beer–Lambert over the segment travelled: to the surface, or to a
        # medium event that pre-empts it; an escaped ray travels none.
        seg = torch.where(hit.valid, hit.t, 0.0)
        if has_fog:
            seg = torch.where(med_event, t_fog, seg)
        if has_vol:
            seg = torch.where(vol_event, t_vol, seg)
        if has_sss:
            seg = torch.where(sss_event, t_sss, seg)
        transmit = torch.exp(-medium * seg[:, None])
        throughput = throughput * torch.where(active[:, None], transmit, 1.0)

    if scene.env is not None:
        env = envmap_ops.radiance(scene.env, d)
        if nee:
            # The environment is also sampled by NEE: a BSDF-sampled
            # escape from an NEE vertex is the other estimator.
            pdf_env_d = envmap_ops.pdf(scene.env, d)
            w_esc = prev_pdf ** 2 / (prev_pdf ** 2 + pdf_env_d ** 2 + 1e-30)
            env = env * torch.where(prev_nee, w_esc, 1.0)[:, None]
    else:
        env = background_radiance(d, background)
    escaped = active & ~hit.valid
    # A medium event pre-empts the escape.
    if has_fog:
        escaped = escaped & ~med_event
    if has_vol:
        escaped = escaped & ~vol_event
    if has_sss:
        escaped = escaped & ~sss_event
    radiance = radiance + torch.where(escaped[:, None], throughput * env, 0.0)

    mtype, alb, par, emit = materials.gather(scene.material_table, hit.mat_id)
    alb = materials.effective_albedo(mtype, alb, par, emit, hit.position)
    emit = materials.effective_emission(mtype, emit)
    # The base emission: the MIS pdfs of both arms keep it, while a
    # texture scales the accumulated radiance.
    emit_pdf = emit
    # Optional columns, gathered only by scenes that carry them.
    metal_col = cc_col = aniso_col = None
    if scene.mat_aniso is not None:
        aniso_col = _column(scene.mat_aniso, hit.mat_id)
    if scene.mat_metallic is not None:
        metal_col = _column(scene.mat_metallic, hit.mat_id)
        if scene.mat_clearcoat is not None:
            cc_col = _column(scene.mat_clearcoat, hit.mat_id)
    use_mips = scene_mod.uses_mips(scene) and cone is not None
    if scene.attr_shn is not None or scene.textures is not None:
        lod_base = None
        if use_mips:
            # Ray-cone LOD: spread × distance from the camera, stretched
            # by the grazing angle (clamped).
            cos_g = torch.abs(linalg.dot(d, hit.normal))
            dist_c = cone + torch.where(hit.valid, hit.t, 0.0)
            width_c = dist_c * cone_spread / torch.clamp(cos_g, min=0.1)
            s_normal, uv, dens = scene_mod.surface_attributes(
                scene, hit, cone_width=width_c)
            lod_base = torch.log2(torch.clamp(width_c * dens, min=1e-20))
        else:
            s_normal, uv = scene_mod.surface_attributes(scene, hit)

        def lookup(col):
            tid = _column(col, hit.mat_id)
            if use_mips:
                return tid, texture_ops.sample_trilinear(
                    scene.textures, tid, uv, lod_base)
            return tid, texture_ops.sample_bilinear(scene.textures, tid, uv)

        if scene.mat_tex is not None:
            tex_id, tex_rgb = lookup(scene.mat_tex)
            textured = (tex_id >= 0) & hit.valid
            alb = torch.where(textured[:, None], alb * tex_rgb, alb)
            emit = torch.where(
                (textured & (mtype == materials.TYPE_EMISSIVE))[:, None],
                emit * tex_rgb, emit)
        if scene.mat_mrtex is not None:
            mr_id, mr = lookup(scene.mat_mrtex)
            mr_on = (mr_id >= 0) & hit.valid
            par = torch.where(mr_on, par * mr[:, 1], par)
            if metal_col is not None:
                metal_col = torch.where(mr_on, metal_col * mr[:, 2],
                                        metal_col)
        if scene.attr_shn is not None or scene.mat_ntex is not None:
            hit = hit._replace(normal=s_normal)
    live = active & hit.valid
    # Medium-event lanes skip the surface (and interior events its NEE,
    # which the enclosing boundary would occlude).
    if has_fog:
        live = live & ~med_event
    if has_vol:
        live = live & ~vol_event
    if has_sss:
        live = live & ~sss_event

    nee_on = nee and scene.lights is not None
    emit_w = torch.ones(r, dtype=torch.float32, device=dev)
    if nee_on:
        # MIS: a BSDF-sampled hit on a light is the "other estimator" of the
        # direct light the previous vertex already sampled.
        total_power = scene.lights.total_power
        cos_l = torch.abs(linalg.dot(d, hit.normal))
        pdf_l = (hit.t * hit.t * linalg.luminance(emit_pdf)
                 / (cos_l * total_power + 1e-20))
        w = prev_pdf ** 2 / (prev_pdf ** 2 + pdf_l ** 2 + 1e-30)
        is_light = hit.valid & (torch.amax(emit, dim=-1) > 0.0)
        emit_w = torch.where(prev_nee & is_light & (total_power > 0.0), w, 1.0)
    radiance = radiance + torch.where(
        live[:, None], throughput * emit * emit_w[:, None], 0.0
    )

    nee_lobe = materials.is_nee_type(mtype)
    n_shadow = torch.zeros((), dtype=torch.int64, device=dev)

    def lobe(wi, cos_w, rep: int = 1):
        """The finite-pdf lobe (f, pdf_b) toward ``wi``: GGX (anisotropic
        where the column says so) for GGX hits, the principled sum with
        its mixture pdf for principled hits, Lambertian otherwise. With
        ``rep`` > 1 the hit's columns are repeated per RIS candidate."""
        def rp(x):
            return x if rep == 1 else torch.repeat_interleave(x, rep, dim=0)
        is_g = rp(mtype) == materials.TYPE_GGX
        a, nrm, view = rp(alb), rp(hit.normal), rp(-d)
        f_g, pdf_g = materials.ggx_eval(a, rp(par), nrm, view, wi)
        f_l = torch.where(is_g[:, None], f_g, a * INV_PI)
        p_b = torch.where(is_g, pdf_g, cos_w * INV_PI)
        if aniso_col is not None:
            an = rp(aniso_col)
            f_ga, pdf_ga = materials.ggx_eval_aniso(a, rp(par), an, nrm,
                                                    view, wi)
            sel_a = is_g & (an > 1e-6)
            f_l = torch.where(sel_a[:, None], f_ga, f_l)
            p_b = torch.where(sel_a, pdf_ga, p_b)
        if metal_col is not None:
            is_pr = rp(mtype) == materials.TYPE_PRINCIPLED
            f_p, pdf_p = materials.principled_eval(
                a, rp(metal_col), rp(par), nrm, view, wi,
                clearcoat=None if cc_col is None else rp(cc_col))
            f_l = torch.where(is_pr[:, None], f_p, f_l)
            p_b = torch.where(is_pr, pdf_p, p_b)
        return f_l, p_b

    def medium_origin(surface):
        """The NEE origin: the medium event's point on event lanes."""
        if has_fog:
            surface = torch.where(med_event[:, None], o_med, surface)
        if has_vol:
            surface = torch.where(vol_event[:, None], o_vol, surface)
        return surface

    if nee_on:
        # Surface and medium vertices share one light sample and shadow
        # ray; the origin selects per lane.
        o_nee = medium_origin(hit.position)
        m = nee_candidates
        if m > 1:
            uu = _uniforms(kd, rng.STREAM_NEE, 3 * m + 1)
            ul_all = uu[:, :3 * m].reshape(r, m, 3)
            if ld_nee is not None and any_first:
                ul_all = torch.cat([first_draws(ld_nee, ul_all[:, 0])[:, None],
                                    ul_all[:, 1:]], dim=1)
            ris_medium = None
            if has_fog or has_vol:
                zero = torch.zeros(r, dtype=torch.float32, device=dev)
                is_med = torch.zeros(r, dtype=torch.bool, device=dev)
                ph_g = alb_med = zero
                if has_fog:
                    is_med = is_med | med_event
                    ph_g = torch.where(med_event, fog_g, ph_g)
                    alb_med = torch.where(med_event, fog_albedo, alb_med)
                if has_vol:
                    is_med = is_med | vol_event
                    ph_g = torch.where(vol_event, vol.g, ph_g)
                    alb_med = torch.where(vol_event, vol_albedo, alb_med)
                ris_medium = (is_med, ph_g, alb_med)
            lp, ln, lemit, pdf_sa, ris_ok, ul = _ris_pick(
                scene, ul_all, uu[:, 3 * m], o_nee, hit.normal, lobe, m, d,
                medium=ris_medium)
        elif ld_nee is not None and not per_lane and first:
            ul = ld_nee
        else:
            ul = _uniforms(kd, rng.STREAM_NEE, 3)
            if ld_nee is not None and per_lane:
                ul = first_draws(ld_nee, ul)
        if scene.lights.uv0 is not None:
            # Textured emitters: the winner (or the one sample) again with
            # its uv and atlas id, from the same draws; the texel scales
            # the contribution, the pdfs keep the base emission. RIS keeps
            # its effective density.
            lp, ln, lemit, pdf_one, uv_l, tex_l = (
                lights_ops.sample_solid_angle(scene.lights, ul, o_nee,
                                              with_uv=True))
            if m == 1:
                pdf_sa = pdf_one
            ltex_rgb = texture_ops.sample_bilinear(scene.textures, tex_l,
                                                   uv_l)
            lemit_mod = torch.where((tex_l >= 0)[:, None], lemit * ltex_rgb,
                                    lemit)
        else:
            if m == 1:
                lp, ln, lemit, pdf_sa = lights_ops.sample_solid_angle(
                    scene.lights, ul, o_nee)
            lemit_mod = lemit
        wi_vec = lp - o_nee
        dist2 = linalg.dot(wi_vec, wi_vec)
        dist = torch.sqrt(torch.clamp(dist2, min=1e-12))
        wi = wi_vec / dist[:, None]
        cos_s = linalg.dot(hit.normal, wi)
        cos_l = torch.abs(linalg.dot(ln, wi))
        total_power = scene.lights.total_power
        cand = (live & nee_lobe & (cos_s > 1e-6) & (cos_l > 1e-6)
                & (dist2 > 1e-8) & (total_power > 0.0))
        if has_fog:
            cand = cand | (med_event & (cos_l > 1e-6) & (dist2 > 1e-8)
                           & (total_power > 0.0) & (fog_albedo > 0.0))
        if has_vol:
            cand = cand | (vol_event & (cos_l > 1e-6) & (dist2 > 1e-8)
                           & (total_power > 0.0) & (vol_albedo > 0.0))
        if m > 1:
            cand = cand & ris_ok
        t_shadow = dist * (1.0 - 1e-3)
        occluded = scene_mod.occluded_batch(
            scene, o_nee, wi, t_shadow, traversal, active=cand, time=time,
            bin_rays=bin_rays, counts=counts)
        vis = cand & ~occluded
        n_shadow = n_shadow + cand.sum()

        f_lobe, pdf_b = lobe(wi, cos_s)
        # The MIS weight keeps the one-sample area-law pdf on both arms;
        # the estimate divides by the true (or RIS effective) density.
        pdf_l = dist2 * linalg.luminance(lemit) / (cos_l * total_power
                                                   + 1e-20)
        # Medium vertices swap (BSDF · cosθ) for (albedo · phase); the
        # phase is their pdf_b.
        if has_fog:
            p_phase_l = sampling_ops.hg_phase(fog_g, linalg.dot(d, wi))
            pdf_b = torch.where(med_event, p_phase_l, pdf_b)
        if has_vol:
            p_phase_lv = sampling_ops.hg_phase(vol.g, linalg.dot(d, wi))
            pdf_b = torch.where(vol_event, p_phase_lv, pdf_b)
        w = pdf_l ** 2 / (pdf_l ** 2 + pdf_b ** 2 + 1e-30)
        scale = cos_s / torch.clamp(pdf_sa, min=1e-20) * w
        contrib = throughput * f_lobe * lemit_mod * scale[:, None]
        if has_fog:
            scale_med = w / torch.clamp(pdf_sa, min=1e-20)
            contrib_med = (throughput * lemit_mod
                           * (fog_albedo * p_phase_l * scale_med)[:, None])
            # Every arm pays the fog's transmittance over the shadow ray.
            contrib = torch.where(med_event[:, None], contrib_med,
                                  contrib) * torch.exp(
                -fog_sigma_t * dist)[:, None]
        if has_vol:
            scale_med_v = w / torch.clamp(pdf_sa, min=1e-20)
            contrib_med_v = (throughput * lemit_mod
                             * (vol_albedo * p_phase_lv
                                * scale_med_v)[:, None])
            contrib = torch.where(vol_event[:, None], contrib_med_v, contrib)
            # Every arm pays the grid's transmittance (surface arms too).
            t_vnee = volume_ops.transmittance(
                vol, keys, depth, o_nee, wi, t_shadow, volume_ops.SALT_NEE,
                active=vis)
            contrib = contrib * t_vnee[:, None]
        radiance = radiance + torch.where(vis[:, None], contrib, 0.0)

    if nee and scene.env is not None:
        # Environment NEE: a direction ∝ luminance·sinθ, an any-hit ray
        # toward infinity, MIS against the lobe. Disjoint from the area
        # lights, so the two estimates add. Grid-event vertices take part
        # (a bounded grid sees the sky), with the phase as their lobe.
        ue = _uniforms(kd, rng.STREAM_ENV, 2)
        wi_e, pdf_e = envmap_ops.sample(scene.env, ue[:, 0], ue[:, 1])
        le = envmap_ops.radiance(scene.env, wi_e)
        cos_e = linalg.dot(hit.normal, wi_e)
        cand_e = live & nee_lobe & (cos_e > 1e-6) & (pdf_e > 1e-12)
        o_env = hit.position
        if has_vol:
            cand_e = cand_e | (vol_event & (pdf_e > 1e-12)
                               & (vol_albedo > 0.0))
            o_env = torch.where(vol_event[:, None], o_vol, o_env)
        t_env = torch.full((r,), ENV_SHADOW_T, dtype=torch.float32,
                           device=dev)
        occ_e = scene_mod.occluded_batch(
            scene, o_env, wi_e, t_env, traversal, active=cand_e, time=time,
            bin_rays=bin_rays, counts=counts)
        vis_e = cand_e & ~occ_e
        n_shadow = n_shadow + cand_e.sum()
        f_lobe_e, pdf_b_e = lobe(wi_e, cos_e)
        if has_vol:
            p_ph_e = sampling_ops.hg_phase(vol.g, linalg.dot(d, wi_e))
            pdf_b_e = torch.where(vol_event, p_ph_e, pdf_b_e)
        w_e = pdf_e ** 2 / (pdf_e ** 2 + pdf_b_e ** 2 + 1e-30)
        scale_e = cos_e / torch.clamp(pdf_e, min=1e-20) * w_e
        contrib_e = throughput * f_lobe_e * le * scale_e[:, None]
        if has_fog:
            # Homogeneous fog transmits nothing to infinity.
            contrib_e = contrib_e * torch.exp(-fog_sigma_t * ENV_SHADOW_T)
        if has_vol:
            contrib_med_e = throughput * le * (
                vol_albedo * p_ph_e * w_e
                / torch.clamp(pdf_e, min=1e-20))[:, None]
            contrib_e = torch.where(vol_event[:, None], contrib_med_e,
                                    contrib_e)
            t_venv = volume_ops.transmittance(
                vol, keys, depth, o_env, wi_e, t_env, volume_ops.SALT_ENV,
                active=vis_e)
            contrib_e = contrib_e * t_venv[:, None]
        radiance = radiance + torch.where(vis_e[:, None], contrib_e, 0.0)

    if nee and scene.delta is not None:
        # Delta lights: NEE alone with MIS weight 1 (a BSDF ray never hits
        # a zero-extent light); the sampled radiance carries falloff, 1/d²
        # and the pick probability. Medium vertices take part with the
        # phase for f·cosθ.
        ud = _uniforms(kd, rng.STREAM_DELTA, None)
        o_dl = medium_origin(hit.position)
        wi_d, t_sh_d, le_d = lights_ops.sample_delta(scene.delta, ud, o_dl)
        cos_d = linalg.dot(hit.normal, wi_d)
        cand_d = live & nee_lobe & (cos_d > 1e-6)
        if has_fog:
            cand_d = cand_d | (med_event & (fog_albedo > 0.0))
        if has_vol:
            cand_d = cand_d | (vol_event & (vol_albedo > 0.0))
        occ_d = scene_mod.occluded_batch(
            scene, o_dl, wi_d, t_sh_d, traversal, active=cand_d, time=time,
            bin_rays=bin_rays, counts=counts)
        vis_d = cand_d & ~occ_d
        n_shadow = n_shadow + cand_d.sum()
        f_lobe_d, _ = lobe(wi_d, cos_d)
        contrib_d = throughput * f_lobe_d * le_d * cos_d[:, None]
        if has_fog:
            p_ph_d = sampling_ops.hg_phase(fog_g, linalg.dot(d, wi_d))
            contrib_med_d = throughput * le_d * (fog_albedo * p_ph_d)[:, None]
            contrib_d = torch.where(med_event[:, None], contrib_med_d,
                                    contrib_d) * torch.exp(
                -fog_sigma_t * t_sh_d)[:, None]
        if has_vol:
            p_ph_dv = sampling_ops.hg_phase(vol.g, linalg.dot(d, wi_d))
            contrib_med_dv = throughput * le_d * (vol_albedo
                                                  * p_ph_dv)[:, None]
            contrib_d = torch.where(vol_event[:, None], contrib_med_dv,
                                    contrib_d)
            t_vdl = volume_ops.transmittance(
                vol, keys, depth, o_dl, wi_d, t_sh_d, volume_ops.SALT_DELTA,
                active=vis_d)
            contrib_d = contrib_d * t_vdl[:, None]
        radiance = radiance + torch.where(vis_d[:, None], contrib_d, 0.0)

    u = _uniforms(kd, rng.STREAM_SCATTER, 5)
    if ld_scatter is not None and any_first:
        u = torch.cat([first_draws(ld_scatter, u[:, :2]), u[:, 2:]], dim=1)
    d_out, atten, scattered, scatter_pdf = materials.scatter(
        mtype, alb, par, emit, hit.normal, d, hit.front, u,
        param2=(None if scene.mat_param2 is None
                else _column(scene.mat_param2, hit.mat_id)),
        disp=(None if scene.mat_disp is None
              else _column(scene.mat_disp, hit.mat_id)),
        throughput=throughput, metallic=metal_col, clearcoat=cc_col,
        aniso=aniso_col,
    )
    throughput = throughput * torch.where(live[:, None], atten, 1.0)
    active = live & scattered
    if has_fog:
        # A fog event carries the albedo and continues along the phase
        # direction; pure-absorption fog ends the path.
        throughput = throughput * torch.where(med_event[:, None],
                                              fog_albedo, 1.0)
        active = active | (med_event & (fog_albedo > 0.0))
    if has_vol:
        if vol.emission is not None:
            # Emissive grid: (sigma_a/sigma_t)·Le(x) at a real collision is
            # the unbiased estimate of ∫ T·sigma_a·Le dt.
            le_v = volume_ops.emission_at(vol, o_vol)
            radiance = radiance + torch.where(
                vol_event[:, None], throughput * (1.0 - vol_albedo) * le_v,
                0.0)
        throughput = throughput * torch.where(vol_event[:, None],
                                              vol_albedo, 1.0)
        active = active | (vol_event & (vol_albedo > 0.0))
    if has_sss:
        # An interior event's weight is exactly 1; the walk goes on.
        active = active | sss_event

    if per_lane:
        # Per-lane roulette over the same draw: lanes short of
        # rr_start_depth always survive, unweighted.
        rr_u = _uniforms(kd, rng.STREAM_RR, None)
        p_continue = torch.clamp(torch.amax(throughput, dim=-1), 0.05, 1.0)
        do_rr = depth >= rr_start_depth
        survive = ~do_rr | (rr_u < p_continue)
        throughput = torch.where((do_rr & survive)[:, None],
                                 throughput / p_continue[:, None], throughput)
        active = active & survive
    elif depth >= rr_start_depth:
        # Counter-based streams: skipping this draw at shallow depths
        # changes no other stream.
        rr_u = _uniforms(kd, rng.STREAM_RR, None)
        p_continue = torch.clamp(torch.amax(throughput, dim=-1), 0.05, 1.0)
        survive = rr_u < p_continue
        throughput = torch.where(survive[:, None],
                                 throughput / p_continue[:, None], throughput)
        active = active & survive

    o = hit.position
    if has_fog:
        o = torch.where(med_event[:, None], o_med, o)
        d_out = torch.where(med_event[:, None], d_phase, d_out)
        scatter_pdf = torch.where(med_event, p_phase, scatter_pdf)
    if has_vol:
        o = torch.where(vol_event[:, None], o_vol, o)
        d_out = torch.where(vol_event[:, None], d_phase_v, d_out)
        scatter_pdf = torch.where(vol_event, p_phase_v, scatter_pdf)
    if has_sss:
        o = torch.where(sss_event[:, None], o_sss, o)
        d_out = torch.where(sss_event[:, None], d_phase_s, d_out)
        scatter_pdf = torch.where(sss_event, p_phase_s, scatter_pdf)
    d = torch.where(active[:, None], d_out, d)
    prev_pdf = torch.clamp(scatter_pdf, min=1e-6)
    prev_nee = live & nee_lobe
    # Phase sampling is a finite-pdf lobe: the next emissive hit MIS-es
    # against it. Interior events keep prev_nee off (they sample no NEE).
    if has_fog:
        prev_nee = prev_nee | med_event
    if has_vol:
        prev_nee = prev_nee | vol_event
    out = (radiance, throughput, o, d, active, prev_pdf, prev_nee)
    if has_media or has_sss:
        # Handoff at dielectric boundaries: a scattered direction into the
        # surface (against the ray-facing normal) is a transmission;
        # entering takes the material's rows, leaving returns to vacuum.
        is_diel = ((mtype == materials.TYPE_DIELECTRIC)
                   | (mtype == materials.TYPE_ROUGH_DIELECTRIC))
        transmitted = live & is_diel & (linalg.dot(d_out, hit.normal) < 0.0)
        enter = (transmitted & hit.front)[:, None]
        leave = (transmitted & ~hit.front)[:, None]
    if has_media:
        medium = torch.where(enter, _column(scene.mat_absorb, hit.mat_id),
                             torch.where(leave, 0.0, medium))
        out = out + (medium,)
    if has_sss:
        sss = torch.where(enter, _column(scene.mat_interior, hit.mat_id),
                          torch.where(leave, 0.0, sss))
        out = out + (sss,)
    if use_mips:
        # The cone grows by the segment travelled (to the surface, or to a
        # medium event); escaped and dead lanes keep their value (never
        # read again).
        seg_c = torch.where(hit.valid, hit.t, 0.0)
        if has_fog:
            seg_c = torch.where(med_event, t_fog, seg_c)
        if has_vol:
            seg_c = torch.where(vol_event, t_vol, seg_c)
        if has_sss:
            seg_c = torch.where(sss_event, t_sss, seg_c)
        out = out + (cone + seg_c,)
    return out + (n_shadow,) if return_shadow_count else out


def cone_spread_of(camera, config):
    """Angular spread of a pixel's primary ray cone (the texture LOD's
    footprint): the vertical field of view over the image rows, as the
    float32 scalar the JAX package computes. A motion pair uses its
    opening pose."""
    cam = camera[0] if isinstance(camera, tuple) else camera
    return float(np.float32(2.0) * np.float32(cam.half_fov)
                 / np.float32(config.height))


def shutter_time(config, seed, pixel_index, sample_index, keys):
    """Per-path shutter time in [0, 1): the one draw that camera motion
    and object motion share (``STREAM_TIME``, LD or plain), so rigid
    camera and object motion stay consistent. ``keys`` are the per-path
    keys of ``camera_sample``."""
    if config.sampler == "ld":
        return rng.ld_scalar(seed, pixel_index, sample_index,
                             rng.STREAM_TIME)
    return rng.uniform(rng.stream_key(keys, 0, rng.STREAM_TIME))


def camera_sample(camera, config, seed, pixel_index, sample_index):
    """Primary rays for a batch of (pixel, sample) pairs. Returns (keys,
    origin, direction); the keys are the per-path base keys every bounce
    stream derives from. ``camera`` is one camera or an ``(open, close)``
    motion pair, traced through the pose at each path's
    ``shutter_time``."""
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
    if isinstance(camera, tuple):
        camera = camera_ops.lerp(
            camera[0], camera[1],
            shutter_time(config, seed, pixel_index, sample_index, k))
    s = (x + j0) / w
    t = (y + j1) / h
    o, d = camera_ops.generate_ray(camera, s, t, l0, l1)
    return k, o, d
