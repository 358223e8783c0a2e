"""Per-bounce shading core (the JAX package's ``models/shading.py``).

One bounce = batched closest-hit query -> Beer–Lambert absorption over
the segment -> environment/emissive accumulation (MIS-weighted) ->
next-event estimation with shadow rays (area lights, optionally by RIS;
the environment map; delta lights) -> branchless BSDF scatter -> Russian
roulette -> the medium handoff at dielectric boundaries. The random draws
are the JAX package's threefry streams, bit for bit (``ops.rng``), so both
packages follow the same paths for the same (pixel, sample, bounce)
counters. Each optional branch runs only for a scene that carries its
data (``mat_absorb``, ``env``, ``delta``, ``mat_param2``, ``mat_disp``,
``mat_aniso``, surface attributes and textures, a mip pyramid) or a config
that asks for it (``nee_candidates > 1``), and draws no stream otherwise,
so every other scene keeps its ops and streams.

Not ported yet: fog, volumes and subsurface media (ROADMAP queue A item
16) and per-ray depth counters (item 13).
"""

from __future__ import annotations

import numpy as np
import torch

from pathtracing_tpu_torch.models import scene as scene_mod
from pathtracing_tpu_torch.ops import camera as camera_ops
from pathtracing_tpu_torch.ops import envmap as envmap_ops
from pathtracing_tpu_torch.ops import lights as lights_ops
from pathtracing_tpu_torch.ops import linalg, materials, rng
from pathtracing_tpu_torch.ops import texture as texture_ops

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


def _ris_pick(scene, ul_all, u_pick, o_nee, normal, lobe, m: int):
    """Talbot RIS over ``m`` power-CDF light candidates per vertex: all
    R·m candidates sampled in one call (gather-mode tables fetch their
    rows through ``pgather.gather_rows``), scored by the unshadowed
    luminance(f·Le)·cosθ per solid angle, one resampled ∝ score. Returns
    the winner's (point, normal, emit), its effective density m·p̂/Σw
    (inf where no candidate scores), ``ris_ok`` and the winner's uniforms;
    the candidates' tensors go out of scope here."""
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


def bounce_batch(scene, o, d, keys, depth: int, radiance, throughput,
                 active, rr_start_depth, background: str, traversal: str,
                 nee: bool = False, prev_pdf=None, prev_nee=None,
                 ld_nee=None, ld_scatter=None, nee_candidates: int = 1,
                 return_shadow_count: bool = False, time=None, medium=None,
                 cone=None, cone_spread=None):
    """One bounce for a whole (R,) ray batch (``depth`` an int: the
    megakernel's bounce index). ``keys`` are the per-path keys
    (``camera_sample``); ``ld_nee`` ((R, 3)) / ``ld_scatter`` ((R, 2))
    optionally replace the first vertex's NEE and scatter draws with the
    precomputed low-discrepancy ones (under RIS, candidate 0's); ``time``
    ((R,), scenes with motion-blurred instances) is the per-path shutter
    time, passed to the closest-hit and the shadow queries.

    ``medium`` ((R, 3), scenes with ``mat_absorb``; zeros when None) is
    the per-path interior sigma_a: this bounce's segment loses
    exp(−sigma_a·t) of throughput, and the coefficient changes where the
    scatter transmits through a dielectric (entering: the material's row;
    leaving: vacuum). ``nee_candidates`` M > 1 picks the area light by
    RIS over M candidates (``3M + 1`` uniforms of the NEE stream), still
    one shadow ray per vertex.

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
    then ``medium`` for scenes with ``mat_absorb``, then ``cone`` for
    scenes with a mip pyramid, then with
    ``return_shadow_count`` the number of shadow rays traced (area-light,
    environment and delta waves; an int64 0-d tensor)."""
    if not isinstance(depth, int):
        raise NotImplementedError(
            "per-ray depth counters (the wavefront engine) are not ported "
            "yet (ROADMAP queue A item 13)"
        )
    r = o.shape[0]
    dev = o.device
    if prev_pdf is None:
        prev_pdf = torch.zeros(r, dtype=torch.float32, device=dev)
    if prev_nee is None:
        prev_nee = torch.zeros(r, dtype=torch.bool, device=dev)
    kd = rng.fold_in(keys, depth)
    first = depth == 0

    hit = scene_mod.intersect_batch(scene, o, d, traversal, active=active,
                                    time=time)

    has_media = scene.mat_absorb is not None
    if has_media:
        if medium is None:
            medium = torch.zeros((r, 3), dtype=torch.float32, device=dev)
        # Beer–Lambert over the segment travelled; an escaped ray travels
        # none (its t is inf, so the segment comes from ``valid``).
        seg = torch.where(hit.valid, hit.t, 0.0)
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

    if nee_on:
        o_nee = hit.position
        m = nee_candidates
        if m > 1:
            uu = _uniforms(kd, rng.STREAM_NEE, 3 * m + 1)
            ul_all = uu[:, :3 * m].reshape(r, m, 3)
            if ld_nee is not None and first:
                ul_all = torch.cat([ld_nee[:, None, :], ul_all[:, 1:]],
                                   dim=1)
            lp, ln, lemit, pdf_sa, ris_ok, ul = _ris_pick(
                scene, ul_all, uu[:, 3 * m], o_nee, hit.normal, lobe, m)
        elif ld_nee is not None and first:
            ul = ld_nee
        else:
            ul = _uniforms(kd, rng.STREAM_NEE, 3)
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
        if m > 1:
            cand = cand & ris_ok
        t_shadow = dist * (1.0 - 1e-3)
        occluded = scene_mod.occluded_batch(
            scene, o_nee, wi, t_shadow, traversal, active=cand, time=time
        )
        vis = cand & ~occluded
        n_shadow = n_shadow + cand.sum()

        f_lobe, pdf_b = lobe(wi, cos_s)
        # The MIS weight keeps the one-sample area-law pdf on both arms;
        # the estimate divides by the true (or RIS effective) density.
        pdf_l = dist2 * linalg.luminance(lemit) / (cos_l * total_power
                                                   + 1e-20)
        w = pdf_l ** 2 / (pdf_l ** 2 + pdf_b ** 2 + 1e-30)
        scale = cos_s / torch.clamp(pdf_sa, min=1e-20) * w
        contrib = throughput * f_lobe * lemit_mod * scale[:, None]
        radiance = radiance + torch.where(vis[:, None], contrib, 0.0)

    if nee and scene.env is not None:
        # Environment NEE: a direction ∝ luminance·sinθ, an any-hit ray
        # toward infinity, MIS against the lobe. Disjoint from the area
        # lights, so the two estimates add.
        ue = _uniforms(kd, rng.STREAM_ENV, 2)
        wi_e, pdf_e = envmap_ops.sample(scene.env, ue[:, 0], ue[:, 1])
        le = envmap_ops.radiance(scene.env, wi_e)
        cos_e = linalg.dot(hit.normal, wi_e)
        cand_e = live & nee_lobe & (cos_e > 1e-6) & (pdf_e > 1e-12)
        occ_e = scene_mod.occluded_batch(
            scene, hit.position, wi_e,
            torch.full((r,), ENV_SHADOW_T, dtype=torch.float32, device=dev),
            traversal, active=cand_e, time=time)
        vis_e = cand_e & ~occ_e
        n_shadow = n_shadow + cand_e.sum()
        f_lobe_e, pdf_b_e = lobe(wi_e, cos_e)
        w_e = pdf_e ** 2 / (pdf_e ** 2 + pdf_b_e ** 2 + 1e-30)
        scale_e = cos_e / torch.clamp(pdf_e, min=1e-20) * w_e
        contrib_e = throughput * f_lobe_e * le * scale_e[:, None]
        radiance = radiance + torch.where(vis_e[:, None], contrib_e, 0.0)

    if nee and scene.delta is not None:
        # Delta lights: NEE alone with MIS weight 1 (a BSDF ray never hits
        # a zero-extent light); the sampled radiance carries falloff, 1/d²
        # and the pick probability.
        ud = _uniforms(kd, rng.STREAM_DELTA, None)
        wi_d, t_sh_d, le_d = lights_ops.sample_delta(scene.delta, ud,
                                                     hit.position)
        cos_d = linalg.dot(hit.normal, wi_d)
        cand_d = live & nee_lobe & (cos_d > 1e-6)
        occ_d = scene_mod.occluded_batch(
            scene, hit.position, wi_d, t_sh_d, traversal, active=cand_d,
            time=time)
        vis_d = cand_d & ~occ_d
        n_shadow = n_shadow + cand_d.sum()
        f_lobe_d, _ = lobe(wi_d, cos_d)
        contrib_d = throughput * f_lobe_d * le_d * cos_d[:, None]
        radiance = radiance + torch.where(vis_d[:, None], contrib_d, 0.0)

    u = _uniforms(kd, rng.STREAM_SCATTER, 5)
    if ld_scatter is not None and first:
        u = torch.cat([ld_scatter, u[:, 2:]], dim=1)
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
    if has_media:
        # Medium handoff: a scattered direction into the surface (against
        # the ray-facing normal) is a transmission.
        is_diel = ((mtype == materials.TYPE_DIELECTRIC)
                   | (mtype == materials.TYPE_ROUGH_DIELECTRIC))
        transmitted = live & is_diel & (linalg.dot(d_out, hit.normal) < 0.0)
        medium = torch.where(
            (transmitted & hit.front)[:, None],
            _column(scene.mat_absorb, hit.mat_id),
            torch.where((transmitted & ~hit.front)[:, None], 0.0, medium))
        out = out + (medium,)
    if use_mips:
        # The cone grows by the segment travelled; escaped and dead lanes
        # keep their value (never read again).
        out = out + (cone + torch.where(hit.valid, hit.t, 0.0),)
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
