"""Branchless BSDF table (the JAX package's ``ops/materials.py``): the
Lambertian, checker, metal, GGX (isotropic and anisotropic), dielectric
(smooth, dispersive and rough), emissive and principled
(metallic-roughness, with clearcoat) lobes. Every lobe is evaluated for
every ray and the result selected by material type.

Materials are an SoA table indexed by ``mat_id``:
  mat_type (K,) int32, mat_albedo (K,3) f32, mat_param (K,) f32
  (metal fuzz / GGX alpha / dielectric IOR / principled perceptual
  roughness), mat_emit (K,3) f32. Optional columns, each present only
  when some material uses it, so other scenes never build its lobe:
  mat_metallic (K,) and mat_clearcoat (K, 2) for principled materials,
  mat_param2 (K,) the rough dielectric's GGX alpha, mat_disp (K,) the
  dispersive dielectric's IOR spread and mat_aniso (K,) the GGX
  anisotropy.
"""

from __future__ import annotations

import torch

from pathtracing_tpu_torch.ops import linalg, sampling

TYPE_LAMBERTIAN = 0
TYPE_METAL = 1
TYPE_DIELECTRIC = 2
TYPE_EMISSIVE = 3
TYPE_CHECKER = 4
TYPE_GGX = 5
TYPE_ROUGH_DIELECTRIC = 6
TYPE_PRINCIPLED = 7

INV_PI = 0.3183098861837907
GGX_MIN_ALPHA = 1e-3


def is_diffuse_type(mat_type):
    """Types shaded as Lambertian (cosine lobe + NEE-eligible)."""
    return (mat_type == TYPE_LAMBERTIAN) | (mat_type == TYPE_CHECKER)


def is_nee_type(mat_type):
    """Types with a finite BSDF pdf — eligible for light sampling."""
    return (is_diffuse_type(mat_type) | (mat_type == TYPE_GGX)
            | (mat_type == TYPE_PRINCIPLED))


def _ggx_d(alpha2, cos_h):
    c2 = torch.square(torch.clamp(cos_h, min=0.0))
    denom = c2 * (alpha2 - 1.0) + 1.0
    return alpha2 * INV_PI / torch.clamp(denom * denom, min=1e-12)


def _smith_g1(alpha2, cos_x):
    c = torch.clamp(cos_x, min=1e-6)
    return 2.0 * c / (c + torch.sqrt(alpha2 + (1.0 - alpha2) * c * c))


def _schlick5(x):
    return torch.pow(torch.clamp(1.0 - x, 0.0, 1.0), 5.0)


def ggx_eval(f0, alpha, normal, view, light):
    """GGX conductor BRDF and its NDF-sampling pdf toward ``light``.
    Returns (f (..., 3), pdf (...,)), zero outside the upper hemisphere."""
    alpha = torch.clamp(alpha, min=GGX_MIN_ALPHA)
    alpha2 = alpha * alpha
    cos_v = linalg.dot(normal, view)
    cos_l = linalg.dot(normal, light)
    h = linalg.normalize(view + light)
    cos_h = linalg.dot(normal, h)
    vh = linalg.dot(view, h)
    d = _ggx_d(alpha2, cos_h)
    g = _smith_g1(alpha2, cos_v) * _smith_g1(alpha2, cos_l)
    fres = f0 + (1.0 - f0) * _schlick5(vh)[..., None]
    ok = (cos_v > 1e-6) & (cos_l > 1e-6) & (vh > 1e-6)
    f = fres * (d * g / torch.clamp(4.0 * cos_v * cos_l, min=1e-12))[..., None]
    pdf = d * torch.clamp(cos_h, min=0.0) / torch.clamp(4.0 * vh, min=1e-12)
    return torch.where(ok[..., None], f, 0.0), torch.where(ok, pdf, 0.0)


def _aniso_alphas(alpha, aniso):
    """Disney anisotropy: aspect = sqrt(1 − 0.9·aniso), alpha_x =
    alpha/aspect along the tangent, alpha_y = alpha·aspect; aniso = 0
    gives alpha_x == alpha_y == alpha exactly."""
    aspect = torch.sqrt(torch.clamp(
        1.0 - 0.9 * torch.clamp(aniso, 0.0, 1.0), min=1e-4))
    ax = torch.clamp(alpha / aspect, min=GGX_MIN_ALPHA)
    ay = torch.clamp(alpha * aspect, min=GGX_MIN_ALPHA)
    return ax, ay


def _smith_g1_aniso(ax, ay, wt, wb, wn):
    """Separable Smith masking with the anisotropic Trowbridge-Reitz
    lambda; equal to ``_smith_g1`` at ax == ay."""
    wn_ = torch.clamp(torch.abs(wn), min=1e-6)
    lam = 0.5 * (-1.0 + torch.sqrt(
        1.0 + (torch.square(ax * wt) + torch.square(ay * wb)) / (wn_ * wn_)))
    return 1.0 / (1.0 + lam)


def ggx_eval_aniso(f0, alpha, aniso, normal, view, light):
    """Anisotropic GGX conductor: ``ggx_eval``'s contract with the NDF
    stretched along the tangent frame ``linalg.orthonormal_basis(normal)``
    (a pure function of the shading normal, so every engine sees the same
    frame). Returns (f (..., 3), pdf (...,)); the pdf is
    ``ggx_sample_aniso``'s."""
    alpha = torch.clamp(alpha, min=GGX_MIN_ALPHA)
    ax, ay = _aniso_alphas(alpha, aniso)
    t, b = linalg.orthonormal_basis(normal)

    cos_v = linalg.dot(normal, view)
    cos_l = linalg.dot(normal, light)
    h = linalg.normalize(view + light)
    vh = linalg.dot(view, h)
    ht, hb, hn = linalg.dot(h, t), linalg.dot(h, b), linalg.dot(h, normal)
    e = (torch.square(ht / ax) + torch.square(hb / ay)
         + torch.square(torch.clamp(hn, min=0.0)))
    d_ndf = 1.0 / torch.clamp(torch.pi * ax * ay * e * e, min=1e-12)
    g = (_smith_g1_aniso(ax, ay, linalg.dot(view, t), linalg.dot(view, b),
                         cos_v)
         * _smith_g1_aniso(ax, ay, linalg.dot(light, t),
                           linalg.dot(light, b), cos_l))
    fres = f0 + (1.0 - f0) * _schlick5(vh)[..., None]
    ok = (cos_v > 1e-6) & (cos_l > 1e-6) & (vh > 1e-6)
    f = fres * (d_ndf * g / torch.clamp(4.0 * cos_v * cos_l,
                                        min=1e-12))[..., None]
    pdf = d_ndf * torch.clamp(hn, min=0.0) / torch.clamp(4.0 * vh, min=1e-12)
    return torch.where(ok[..., None], f, 0.0), torch.where(ok, pdf, 0.0)


def ggx_sample_aniso(alpha, aniso, normal, d_in, u1, u2):
    """Sample the anisotropic GGX NDF (PBRT's non-visible-normal form) and
    reflect; returns (d_out, cos_h, vh) as ``ggx_sample``."""
    alpha = torch.clamp(alpha, min=GGX_MIN_ALPHA)
    ax, ay = _aniso_alphas(alpha, aniso)
    t, b = linalg.orthonormal_basis(normal)

    a = 2.0 * torch.pi * u2
    # atan2(ay sinA, ax cosA): the azimuth warped with the density that
    # matches D, safe in every quadrant.
    phi = torch.arctan2(ay * torch.sin(a), ax * torch.cos(a))
    cp, sp = torch.cos(phi), torch.sin(phi)
    inv_a2 = torch.square(cp / ax) + torch.square(sp / ay)
    u1 = torch.clamp(u1, 0.0, 1.0 - 1e-6)
    tan2t = (u1 / (1.0 - u1)) / torch.clamp(inv_a2, min=1e-12)
    cos_h = 1.0 / torch.sqrt(1.0 + tan2t)
    sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
    h = ((sin_h * cp)[..., None] * t + (sin_h * sp)[..., None] * b
         + cos_h[..., None] * normal)
    d_out = linalg.normalize(d_in - 2.0 * linalg.dot(d_in, h)[..., None] * h)
    return d_out, cos_h, linalg.dot(-d_in, h)


def ggx_sample_h(alpha, normal, u1, u2):
    """GGX half-vector around ``normal``; returns (h, cos_h)."""
    alpha = torch.clamp(alpha, min=GGX_MIN_ALPHA)
    u1 = torch.clamp(u1, 0.0, 1.0 - 1e-6)
    cos_h = 1.0 / torch.sqrt(1.0 + alpha * alpha * u1 / (1.0 - u1))
    sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
    phi = 2.0 * torch.pi * u2
    tx, ty = linalg.orthonormal_basis(normal)
    h = ((sin_h * torch.cos(phi))[..., None] * tx
         + (sin_h * torch.sin(phi))[..., None] * ty
         + cos_h[..., None] * normal)
    return h, cos_h


def ggx_sample(alpha, normal, d_in, u1, u2):
    """Sample a GGX half-vector and reflect; returns (d_out, cos_h, vh)."""
    h, cos_h = ggx_sample_h(alpha, normal, u1, u2)
    d_out = linalg.normalize(d_in - 2.0 * linalg.dot(d_in, h)[..., None] * h)
    return d_out, cos_h, linalg.dot(-d_in, h)


def _principled_parts(base, metallic, rough):
    """(F0, diffuse color, GGX alpha) of the metallic-roughness model:
    F0 = lerp(0.04, base, metallic), diffuse = base·(1−metallic),
    alpha = roughness²."""
    m = metallic[..., None]
    f0 = 0.04 * (1.0 - m) + base * m
    dif = base * (1.0 - m)
    alpha = torch.clamp(rough * rough, min=GGX_MIN_ALPHA)
    return f0, dif, alpha


def _principled_pspec(f0, dif, cos_v):
    """Specular-lobe selection probability: luminance of the view Fresnel
    against the diffuse color, clamped so neither lobe starves. A function
    of (material, view) only, so the sampler and the mixture pdf share
    it."""
    fres = f0 + (1.0 - f0) * _schlick5(cos_v)[..., None]
    ls = linalg.luminance(fres)
    ld = linalg.luminance(dif)
    return torch.clamp(ls / torch.clamp(ls + ld, min=1e-12), 0.05, 1.0)


_CC_F0 = 0.04   # clearcoat IOR is fixed at 1.5 (the glTF convention)


def _fc_scalar(cos_x):
    """Schlick Fresnel at the clearcoat's fixed F0 = 0.04."""
    return _CC_F0 + (1.0 - _CC_F0) * _schlick5(cos_x)


def _principled_weights(f0, dif, cos_v, cc):
    """Three-way lobe-pick probabilities (clearcoat, base specular; the
    rest is diffuse). ``cc`` (...,) is the clearcoat strength: 0 rows
    reduce exactly to the two-lobe split."""
    fres = f0 + (1.0 - f0) * _schlick5(cos_v)[..., None]
    ls = linalg.luminance(fres)
    ld = linalg.luminance(dif)
    lc = cc * _fc_scalar(cos_v)
    tot = torch.clamp(ls + ld + lc, min=1e-12)
    p_cc = lc / tot
    p_s = torch.clamp(ls / tot, min=0.05 * (1.0 - p_cc)).clamp(max=1.0)
    return p_cc, p_s


def principled_eval(base, metallic, rough, normal, view, light,
                    clearcoat=None):
    """The principled BSDF toward ``light`` (the NEE arm). Returns
    (f (...,3), pdf (...,)): f = diffuse/π + GGX specular (+ the clearcoat
    layer when ``clearcoat`` (..., 2) [strength, roughness] is given: a
    second GGX at fixed F0 = 0.04 whose view and light Fresnel attenuate
    the base), pdf = the lobe-pick mixture ``scatter`` samples from."""
    f0, dif, alpha = _principled_parts(base, metallic, rough)
    f_spec, pdf_spec = ggx_eval(f0, alpha, normal, view, light)
    cos_l = linalg.dot(normal, light)
    cos_v = linalg.dot(normal, view)
    f = dif * INV_PI + f_spec
    cos_lp = torch.clamp(cos_l, min=0.0)
    if clearcoat is None:
        p_s = _principled_pspec(f0, dif, cos_v)
        pdf = p_s * pdf_spec + (1.0 - p_s) * cos_lp * INV_PI
    else:
        cc = clearcoat[..., 0]
        alpha_cc = torch.clamp(clearcoat[..., 1] * clearcoat[..., 1],
                               min=GGX_MIN_ALPHA)
        f_cc, pdf_cc = ggx_eval(_CC_F0 * torch.ones_like(dif), alpha_cc,
                                normal, view, light)
        atten = ((1.0 - cc * _fc_scalar(cos_v))
                 * (1.0 - cc * _fc_scalar(cos_lp)))
        f = f * atten[..., None] + cc[..., None] * f_cc
        p_cc, p_s = _principled_weights(f0, dif, cos_v, cc)
        pdf = (p_cc * pdf_cc + p_s * pdf_spec
               + (1.0 - p_cc - p_s) * cos_lp * INV_PI)
    ok = (cos_l > 1e-6) & (cos_v > 1e-6)
    return torch.where(ok[..., None], f, 0.0), torch.where(ok, pdf, 0.0)


def effective_albedo(mat_type, albedo, param, emit, position):
    """Surface color at a hit (procedural checker evaluated here)."""
    freq = torch.clamp(param, min=1e-6)[..., None]
    cell = torch.floor(position * freq + 0.5)
    parity = (cell[..., 0] + cell[..., 1] + cell[..., 2]).to(torch.int32) & 1
    checker = torch.where(parity[..., None] == 0, albedo, emit)
    return torch.where((mat_type == TYPE_CHECKER)[..., None], checker, albedo)


def effective_emission(mat_type, emit):
    """Emitted radiance (zero for checker, whose emit slot is color2)."""
    return torch.where((mat_type == TYPE_CHECKER)[..., None], 0.0, emit)


def scatter(mat_type, albedo, param, emit, normal, d_in, front_face, u,
            param2=None, disp=None, throughput=None, metallic=None,
            clearcoat=None, aniso=None):
    """Sample the BSDF for a batch of hits (branchless; see the JAX
    ``scatter``). ``u`` is (..., 5) uniforms: 2 diffuse/GGX, 3 metal fuzz
    and dielectric (a dispersive dielectric picks its channel with the
    metal-only ``u[..., 3]``: no extra stream). Each optional column is
    None for scenes without it, and its lobe is then never built:
    ``param2`` (...,) the rough dielectric's GGX alpha; ``disp`` (...,)
    the IOR spread (blue − red) of dispersive dielectrics, which pick one
    RGB channel c with probability ∝ ``throughput`` (..., 3), refract at
    ior + disp·(c − 1)/2 and weigh tint·onehot(c)/p_c; ``metallic``
    (...,) the metallic column of TYPE_PRINCIPLED rows and ``clearcoat``
    (..., 2) their [strength, roughness] coat (needs ``metallic``);
    ``aniso`` (...,) the anisotropy of TYPE_GGX rows (rows with 0 keep
    the isotropic lobe). Returns (d_out, attenuation, scattered, pdf)
    with pdf 0 for delta lobes."""
    d_diffuse = sampling.cosine_hemisphere(normal, u[..., 0], u[..., 1])
    pdf_diffuse = torch.clamp(linalg.dot(normal, d_diffuse), min=1e-6) * INV_PI

    view = -d_in
    alpha = torch.clamp(param, min=GGX_MIN_ALPHA)
    alpha2 = alpha * alpha
    d_ggx, cos_h, vh = ggx_sample(alpha, normal, d_in, u[..., 0], u[..., 1])
    if aniso is not None:
        # Anisotropic rows re-sample through the stretched NDF from the
        # same uniforms; isotropic rows keep their draws.
        use_a = aniso > 1e-6
        d_ga, cos_h_a, vh_a = ggx_sample_aniso(param, aniso, normal, d_in,
                                               u[..., 0], u[..., 1])
        d_ggx = torch.where(use_a[..., None], d_ga, d_ggx)
        cos_h = torch.where(use_a, cos_h_a, cos_h)
        vh = torch.where(use_a, vh_a, vh)
    cos_v = linalg.dot(normal, view)
    cos_lg = linalg.dot(normal, d_ggx)
    ggx_ok = (cos_lg > 1e-6) & (cos_v > 1e-6) & (vh > 1e-6)
    fres_g = albedo + (1.0 - albedo) * _schlick5(vh)[..., None]
    g2 = _smith_g1(alpha2, cos_v) * _smith_g1(alpha2, cos_lg)
    w_ggx = fres_g * (
        g2 * vh / torch.clamp(cos_v * torch.clamp(cos_h, min=1e-6), min=1e-9)
    )[..., None]
    pdf_ggx = (_ggx_d(alpha2, cos_h) * torch.clamp(cos_h, min=0.0)
               / torch.clamp(4.0 * vh, min=1e-9))
    if aniso is not None:
        # The anisotropic weight is the generic f·cosθ/pdf (the Walter
        # form above is its simplification for the isotropic lobe).
        f_a, pdf_a = ggx_eval_aniso(albedo, param, aniso, normal, view,
                                    d_ggx)
        w_a = f_a * (torch.clamp(cos_lg, min=0.0)
                     / torch.clamp(pdf_a, min=1e-12))[..., None]
        w_ggx = torch.where(use_a[..., None], w_a, w_ggx)
        pdf_ggx = torch.where(use_a, pdf_a, pdf_ggx)

    d_mirror = linalg.reflect(d_in, normal)
    fuzz = param[..., None]
    d_metal = linalg.normalize(
        d_mirror
        + fuzz * sampling.uniform_in_sphere(u[..., 2], u[..., 3], u[..., 4])
    )
    metal_ok = linalg.dot(d_metal, normal) > 0.0

    ior = torch.clamp(param, min=1.0)
    eta = torch.where(front_face, 1.0 / ior, ior)
    cos_i = torch.clamp(-linalg.dot(d_in, normal), max=1.0)
    sin_i = torch.sqrt(torch.clamp(1.0 - cos_i * cos_i, min=0.0))
    cannot_refract = eta * sin_i > 1.0
    reflect_prob = sampling.schlick_fresnel(cos_i, eta)
    do_reflect = cannot_refract | (u[..., 2] < reflect_prob)
    d_refract = linalg.refract(d_in, normal, eta)
    d_dielectric = linalg.normalize(
        torch.where(do_reflect[..., None], d_mirror, d_refract)
    )

    if disp is not None:
        # Dispersive dielectric: one channel ∝ the current throughput, the
        # dielectric interaction rerun at that channel's IOR. Lanes with
        # disp == 0 keep the plain results above bit for bit.
        tp = torch.clamp(throughput, min=0.0)
        tp_sum = torch.sum(tp, dim=-1)
        w = tp / torch.clamp(tp_sum, min=1e-30)[..., None]
        c1 = w[..., 0]
        c2 = c1 + w[..., 1]
        ud = u[..., 3]
        chan = torch.where(ud < c1, 0, torch.where(ud < c2, 1, 2))
        onehot_c = (torch.arange(3, device=chan.device)
                    == chan[..., None]).to(torch.float32)
        p_c = torch.sum(onehot_c * w, dim=-1)
        ior_c = torch.clamp(
            param + disp * 0.5 * (chan.to(torch.float32) - 1.0), min=1.0)
        eta_c = torch.where(front_face, 1.0 / ior_c, ior_c)
        cannot_c = eta_c * sin_i > 1.0
        refl_prob_c = sampling.schlick_fresnel(cos_i, eta_c)
        do_reflect_c = cannot_c | (u[..., 2] < refl_prob_c)
        d_disp = linalg.normalize(torch.where(
            do_reflect_c[..., None], d_mirror,
            linalg.refract(d_in, normal, eta_c)))
        w_disp = albedo * onehot_c / torch.clamp(p_c, min=1e-20)[..., None]
        disp_on = ((mat_type == TYPE_DIELECTRIC) & (disp > 0.0)
                   & (tp_sum > 0.0))
        d_dielectric = torch.where(disp_on[..., None], d_disp, d_dielectric)

    if param2 is not None:
        # Rough dielectric (Walter 2007 microfacet glass): a GGX half
        # vector at the lobe's own alpha (param is the IOR), a Fresnel
        # choice of reflection or refraction through it, weight
        # G2 |v·h| / (|n·v| |n·h|). BSDF-sampled only (pdf 0).
        alpha_r = torch.clamp(param2, min=GGX_MIN_ALPHA)
        h_rd, cos_h_rd = ggx_sample_h(alpha_r, normal, u[..., 0], u[..., 1])
        vh_rd = linalg.dot(-d_in, h_rd)
        sin2_t = torch.square(eta) * torch.clamp(1.0 - vh_rd * vh_rd,
                                                 min=0.0)
        cannot_r = sin2_t > 1.0
        fres_rd = sampling.schlick_fresnel(torch.clamp(vh_rd, 0.0, 1.0), eta)
        refl_rd = cannot_r | (u[..., 2] < fres_rd)
        d_rd = linalg.normalize(torch.where(
            refl_rd[..., None], linalg.reflect(d_in, h_rd),
            linalg.refract(d_in, h_rd, eta)))
        cos_out = linalg.dot(normal, d_rd)
        cos_v_rd = linalg.dot(normal, -d_in)
        # The microfacet must face the viewer and the outgoing direction
        # lie on the side its event implies.
        rd_ok = (vh_rd > 1e-6) & (cos_v_rd > 1e-6) & torch.where(
            refl_rd, cos_out > 1e-6, cos_out < -1e-6)
        a2_rd = alpha_r * alpha_r
        g2_rd = _smith_g1(a2_rd, cos_v_rd) * _smith_g1(a2_rd,
                                                       torch.abs(cos_out))
        w_rd = albedo * (
            g2_rd * vh_rd
            / torch.clamp(cos_v_rd * torch.clamp(cos_h_rd, min=1e-6),
                          min=1e-9)
        )[..., None]

    is_diffuse = is_diffuse_type(mat_type)
    is_metal = mat_type == TYPE_METAL
    is_dielectric = mat_type == TYPE_DIELECTRIC
    is_ggx = mat_type == TYPE_GGX

    d_out = torch.where(
        is_diffuse[..., None], d_diffuse,
        torch.where(is_metal[..., None], d_metal,
                    torch.where(is_ggx[..., None], d_ggx, d_dielectric)),
    )
    attenuation = torch.where(is_ggx[..., None], w_ggx, albedo)
    if disp is not None:
        attenuation = torch.where(disp_on[..., None], w_disp, attenuation)
    scattered = torch.where(
        is_metal, metal_ok,
        torch.where(is_ggx, ggx_ok, is_diffuse | is_dielectric),
    )
    if param2 is not None:
        is_rd = mat_type == TYPE_ROUGH_DIELECTRIC
        d_out = torch.where(is_rd[..., None], d_rd, d_out)
        attenuation = torch.where(is_rd[..., None], w_rd, attenuation)
        scattered = torch.where(is_rd, rd_ok, scattered)
    pdf = torch.where(is_diffuse, pdf_diffuse,
                      torch.where(is_ggx, pdf_ggx, 0.0))

    if metallic is not None:
        # Principled: pick diffuse vs GGX specular (vs clearcoat) by u[2],
        # which the diffuse and GGX lobes leave unused; the same (u0, u1)
        # drive every candidate direction, and the weight is f·cos/pdf
        # with the mixture pdf.
        f0_p, dif_p, alpha_p = _principled_parts(albedo, metallic, param)
        d_spec, _, _ = ggx_sample(alpha_p, normal, d_in, u[..., 0], u[..., 1])
        if clearcoat is None:
            p_s = _principled_pspec(f0_p, dif_p, cos_v)
            d_pr = torch.where((u[..., 2] < p_s)[..., None], d_spec,
                               d_diffuse)
        else:
            alpha_cc = torch.clamp(clearcoat[..., 1] * clearcoat[..., 1],
                                   min=GGX_MIN_ALPHA)
            d_cc, _, _ = ggx_sample(alpha_cc, normal, d_in, u[..., 0],
                                    u[..., 1])
            p_cc, p_s = _principled_weights(f0_p, dif_p, cos_v,
                                            clearcoat[..., 0])
            lobe = u[..., 2]
            d_pr = torch.where(
                (lobe < p_cc)[..., None], d_cc,
                torch.where((lobe < p_cc + p_s)[..., None], d_spec,
                            d_diffuse),
            )
        f_pr, pdf_pr = principled_eval(albedo, metallic, param, normal, view,
                                       d_pr, clearcoat=clearcoat)
        cos_op = linalg.dot(normal, d_pr)
        pr_ok = (cos_op > 1e-6) & (cos_v > 1e-6) & (pdf_pr > 1e-9)
        w_pr = f_pr * (cos_op / torch.clamp(pdf_pr, min=1e-12))[..., None]
        is_pr = mat_type == TYPE_PRINCIPLED
        d_out = torch.where(is_pr[..., None], d_pr, d_out)
        attenuation = torch.where(is_pr[..., None], w_pr, attenuation)
        scattered = torch.where(is_pr, pr_ok, scattered)
        pdf = torch.where(is_pr, pdf_pr, pdf)
    return d_out, attenuation, scattered, pdf


def gather(mat_table, mat_id):
    """The 4 SoA table columns for a batch of material ids (clamped, so a
    miss's id reads row 0; callers mask by hit validity)."""
    mat_type, mat_albedo, mat_param, mat_emit = mat_table
    idx = torch.clamp(mat_id, 0, mat_type.shape[0] - 1).long()
    return mat_type[idx], mat_albedo[idx], mat_param[idx], mat_emit[idx]
