"""Branchless masked BSDF evaluation and sampling keyed by material type
id: port of ``yuki_tpu/bsdf.py`` (:36-486).

There is no per-hit BSDF object: every lane gathers its material row and
the material families present in the scene (``meta.material_types``) are
evaluated masked, then selected by type id.  Lobe maths follow the
reference line for line (materials/bsdfs/*): Lambertian, Oren-Nayar,
specular reflection and transmission, dielectric / conductor / Schlick
Fresnel, Torrance-Sparrow over the Trowbridge-Reitz (GGX) distribution,
and Bsdf::f / Bsdf::sample_f's lobe rules (bsdfs/mod.rs:125-222).
``*_l`` vectors are in the local shading frame (z = shading normal).

Every division has a tensor divisor and every square root is
``vecmath.sqrt``; ``log`` (``roughness_to_alpha``), ``cos`` and ``sin``
(the GGX half-vector) are the only transcendentals.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .sampling import cosine_sample_hemisphere
from .scene.data import MAT_GLASS, MAT_GLOSSY, MAT_MATTE, MAT_METAL
from .surface import Surface
from .textures import eval_texture
from .vecmath import const, dot, is_black, normalize_safe, recip, sqrt

INV_PI = 1.0 / math.pi

# The only transcendentals, named once so that a test can evaluate them
# one way on both sides.
_log, _cos, _sin = torch.log, torch.cos, torch.sin
_ALL_TYPES = (MAT_MATTE, MAT_GLASS, MAT_METAL, MAT_GLOSSY)


class MatParams(NamedTuple):
    """Per-lane material parameters (kd already texture-resolved)."""

    mtype: torch.Tensor  # [N] i32
    c0: torch.Tensor  # [N,3] kd / R / eta / Rs
    c1: torch.Tensor  # [N,3] T / k
    s0: torch.Tensor  # [N] sigma / eta / roughness
    alpha: torch.Tensor  # [N] resolved GGX alpha (metal / glossy)


def roughness_to_alpha(roughness: torch.Tensor) -> torch.Tensor:
    """trowbridge_reitz.rs:22-30's log-polynomial fit."""
    x = _log(torch.clamp(roughness, min=1e-3))
    return (1.62142 + 0.819955 * x + 0.1734 * x * x
            + 0.0171201 * x * x * x + 0.000640711 * x * x * x * x)


def gather_materials(scene, si: Surface, meta=None) -> MatParams:
    """Each lane's material row, textures resolved (``scene``:
    SceneData; ``meta`` None evaluates every texture binding)."""
    row = scene.materials.packed[torch.clamp(si.material, min=0)
                                 .to(torch.int64)]
    mtype = row[..., 0].to(torch.int32)
    c0, c1, s0 = row[..., 1:4], row[..., 4:7], row[..., 7]
    remap = row[..., 8] > 0.5
    tex0 = row[..., 9].to(torch.int32)
    if meta is not None and not meta.has_textures:
        tex0 = torch.full_like(tex0, -1)
    tex_val = eval_texture(scene.textures, torch.clamp(tex0, min=0), si.uv)
    c0 = torch.where((tex0 >= 0)[..., None], tex_val, c0)
    # A float texture (matte sigma, matte.rs:22-41) stores its value
    # replicated across the atlas's RGB row.
    if meta is None or meta.has_sigma_tex:
        tex1 = row[..., 10].to(torch.int32)
        s0_tex = eval_texture(scene.textures, torch.clamp(tex1, min=0),
                              si.uv)[..., 0]
        s0 = torch.where(tex1 >= 0, s0_tex, s0)
    rough = torch.where(remap, roughness_to_alpha(s0), s0)
    # Glossy squares its (possibly remapped) roughness (glossy.rs:49-52).
    rough = torch.where(mtype == MAT_GLOSSY, rough * rough, rough)
    alpha = torch.clamp(rough, min=1e-3)  # TrowbridgeReitz::new's clamp
    return MatParams(mtype=mtype, c0=c0, c1=c1, s0=s0, alpha=alpha)


# --- local-frame trigonometry (bsdfs/mod.rs:225-281) ----------------------


def _cos_theta(w):
    return w[..., 2]


def _cos2(w):
    return w[..., 2] * w[..., 2]


def _sin2(w):
    return torch.clamp(1.0 - _cos2(w), min=0.0)


def _sin_theta(w):
    return sqrt(_sin2(w))


def _tan2(w):
    c2 = _cos2(w)
    return _sin2(w) / torch.where(c2 == 0.0, 1e-30, c2)


def _cs_phi(w, axis):
    st = _sin_theta(w)
    q = w[..., axis] / torch.where(st == 0, 1.0, st)
    return torch.where(st == 0.0, 1.0, torch.clamp(q, -1.0, 1.0))


def _same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0


def to_local(si: Surface, v: torch.Tensor) -> torch.Tensor:
    t = si.frame_t()
    return torch.stack([dot(v, si.ss), dot(v, t), dot(v, si.ns)], dim=-1)


def to_world(si: Surface, v: torch.Tensor) -> torch.Tensor:
    t = si.frame_t()
    return si.ss * v[..., 0:1] + t * v[..., 1:2] + si.ns * v[..., 2:3]


# --- Fresnel (bsdfs/fresnel.rs) -------------------------------------------


def fresnel_dielectric(cos_theta_i, eta_i, eta_t):
    """Dielectric Fresnel reflectance, [N] (fresnel.rs:22-52)."""
    ci = torch.clamp(cos_theta_i, -1.0, 1.0)
    entering = ci > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(ci)
    si_ = sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    st = ei / et * si_
    tir = st >= 1.0
    ct = sqrt(torch.clamp(1.0 - st * st, min=0.0))
    r_par = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-30)
    r_per = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-30)
    fr = 0.5 * (r_par * r_par + r_per * r_per)
    return torch.where(tir, 1.0, fr)


def fresnel_conductor(cos_theta_i, eta, k):
    """Conductor Fresnel reflectance [N,3], eta_i = 1 (fresnel.rs:68-98)."""
    ci = torch.clamp(torch.abs(cos_theta_i), max=1.0)[..., None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    eta2 = eta * eta
    etak2 = k * k
    t0 = eta2 - etak2 - si2
    a2b2 = sqrt(torch.clamp(t0 * t0 + 4.0 * eta2 * etak2, min=0.0))
    t1 = a2b2 + ci2
    a = sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-30)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-30)
    return 0.5 * (rp + rs)


def fresnel_schlick(cos_theta_i, rs):
    ci = torch.clamp(cos_theta_i, -1.0, 1.0)[..., None]
    m = 1.0 - ci
    p5 = m * m
    p5 = p5 * p5 * m
    return rs + (1.0 - rs) * p5


# --- GGX (bsdfs/trowbridge_reitz.rs) --------------------------------------


def ggx_d(wh, alpha):
    t2 = _tan2(wh)
    a2 = alpha * alpha
    c4 = _cos2(wh) * _cos2(wh)
    e = t2 / a2  # isotropic: cos2phi / a2 + sin2phi / a2 = 1 / a2
    val = recip(math.pi * a2 * c4 * (1.0 + e) * (1.0 + e))
    return torch.where(torch.isfinite(t2) & (c4 > 0.0), val, 0.0)


def ggx_lambda(w, alpha):
    abs_tan = sqrt(torch.clamp(_tan2(w), min=0.0))
    at = alpha * abs_tan
    lam = (-1.0 + sqrt(1.0 + at * at)) / const(2.0, at)
    return torch.where(torch.isfinite(abs_tan), lam, 0.0)


def ggx_g(wo, wi, alpha):
    return recip(1.0 + ggx_lambda(wo, alpha) + ggx_lambda(wi, alpha))


def ggx_sample_wh(wo, u, alpha):
    """Non-visible-area sampling (trowbridge_reitz.rs:60-74)."""
    u0 = u[..., 0]
    tan2t = alpha * alpha * u0 / torch.clamp(1.0 - u0, min=1e-7)
    ct = recip(sqrt(1.0 + tan2t))
    phi = 2.0 * math.pi * u[..., 1]
    st = sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    wh = torch.stack([st * _cos(phi), st * _sin(phi), ct], dim=-1)
    return torch.where(_same_hemisphere(wo, wh)[..., None], wh, -wh)


def ggx_pdf(wh, alpha):
    return ggx_d(wh, alpha) * _cos_theta(wh)


def _microfacet_f(wo_l, wi_l, alpha, fr):
    """Torrance-Sparrow with R = 1, times the Fresnel value fr [N,3]
    (microfacet.rs:52-71)."""
    cto = torch.abs(_cos_theta(wo_l))
    cti = torch.abs(_cos_theta(wi_l))
    wh = wi_l + wo_l
    wh_ok = torch.any(wh != 0.0, dim=-1) & (cto > 0.0) & (cti > 0.0)
    wh = normalize_safe(wh)
    dg = ggx_d(wh, alpha) * ggx_g(wo_l, wi_l, alpha)
    f = fr * (dg / torch.clamp(4.0 * cti * cto, min=1e-30))[..., None]
    return torch.where(wh_ok[..., None], f, 0.0)


def _microfacet_fresnel(mp: MatParams, wo_l, wi_l):
    """The Fresnel term at the half vector, face-forwarded to +z
    (microfacet.rs:64-67): conductor for metal, Schlick for glossy."""
    wh = normalize_safe(wi_l + wo_l)
    wh = torch.where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    ci = dot(wi_l, wh)
    return torch.where((mp.mtype == MAT_METAL)[..., None],
                       fresnel_conductor(ci, mp.c0, mp.c1),
                       fresnel_schlick(ci, mp.c0))


# --- the matte diffuse term ------------------------------------------------


def _matte_f(mp: MatParams, wo_l, wi_l, meta=None):
    """Lambertian where sigma is 0, Oren-Nayar otherwise (matte.rs:22-41),
    both kd / pi scaled; without any sigma in the scene only the
    Lambertian term is built."""
    lam = mp.c0 * INV_PI
    if meta is not None and not meta.has_sigma:
        return torch.where(is_black(mp.c0)[..., None], 0.0, lam)
    sigma2 = mp.s0 * mp.s0
    a = 1.0 - sigma2 / (2.0 * (sigma2 + 0.33))
    b = 0.45 * sigma2 / (sigma2 + 0.09)
    # OrenNayar::f receives (wo, wi) into parameters named (wi, wo)
    # (oren_nayar.rs:28); the formula is symmetric, evaluated as written.
    sti = _sin_theta(wo_l)
    sto = _sin_theta(wi_l)
    both = (sti > 1e-4) & (sto > 1e-4)
    d_cos = (_cs_phi(wo_l, 0) * _cs_phi(wi_l, 0)
             + _cs_phi(wo_l, 1) * _cs_phi(wi_l, 1))
    max_cos = torch.where(both, torch.clamp(d_cos, min=0.0), 0.0)
    cti = torch.abs(_cos_theta(wo_l))
    cto = torch.abs(_cos_theta(wi_l))
    first = cti > cto
    sin_alpha = torch.where(first, sto, sti)
    tan_beta = torch.where(first, sti / torch.clamp(cti, min=1e-30),
                           sto / torch.clamp(cto, min=1e-30))
    on = mp.c0 * (INV_PI * (a + b * max_cos * sin_alpha * tan_beta))[..., None]
    f = torch.where((mp.s0 == 0.0)[..., None], lam, on)
    # Matte adds no lobe at all for a black kd (matte.rs:31-38).
    return torch.where(is_black(mp.c0)[..., None], 0.0, f)


# --- public API -------------------------------------------------------------


def _present(meta):
    return set(meta.material_types) if meta is not None else set(_ALL_TYPES)


def bsdf_f(mp: MatParams, si: Surface, wo_w, wi_w, meta=None) -> torch.Tensor:
    """Bsdf::f over every lobe (bsdfs/mod.rs:125-147), summing those on
    the geometric normal's reflect / transmit side; families absent from
    ``meta.material_types`` are not built."""
    wo_l = to_local(si, wo_w)
    wi_l = to_local(si, wi_w)
    reflect = (dot(wi_w, si.n) * dot(wo_w, si.n)) > 0.0
    present = _present(meta)
    f = torch.zeros_like(mp.c0)
    if MAT_MATTE in present:
        f = torch.where((mp.mtype == MAT_MATTE)[..., None],
                        _matte_f(mp, wo_l, wi_l, meta), f)
    if MAT_METAL in present or MAT_GLOSSY in present:
        fr = _microfacet_fresnel(mp, wo_l, wi_l)
        f = torch.where(((mp.mtype == MAT_METAL)
                         | (mp.mtype == MAT_GLOSSY))[..., None],
                        _microfacet_f(wo_l, wi_l, mp.alpha, fr), f)
    # Glass's lobes are both specular: f() sees none.  Every other lobe
    # reflects: zero on the transmit side.
    return torch.where(reflect[..., None], f, 0.0)


class BsdfSample(NamedTuple):
    wi: torch.Tensor  # [N,3] world
    f: torch.Tensor  # [N,3]
    pdf: torch.Tensor  # [N]
    is_specular: torch.Tensor  # [N] bool
    is_transmission: torch.Tensor  # [N] bool
    valid: torch.Tensor  # [N] bool (pdf > 0 and a lobe matched)


def _refract_l(wo_l, s0):
    """The specular transmission direction in the local frame with the
    normal (0,0,1) face-forwarded (specular.rs:69-95).  Returns (wi_l,
    tir)."""
    entering = _cos_theta(wo_l) > 0.0
    eta_i = torch.where(entering, 1.0, s0)
    eta_t = torch.where(entering, s0, 1.0)
    eta = eta_i / eta_t
    n_ff = torch.where(entering, 1.0, -1.0)  # z of the forwarded normal
    cti = n_ff * _cos_theta(wo_l)  # = |cos|
    s2tt = eta * eta * torch.clamp(1.0 - cti * cti, min=0.0)
    tir = s2tt >= 1.0
    ctt = sqrt(torch.clamp(1.0 - s2tt, min=0.0))
    zero = torch.zeros_like(eta)
    wi_l = -wo_l * eta[..., None] + torch.stack(
        [zero, zero, n_ff], dim=-1) * (eta * cti - ctt)[..., None]
    return wi_l, tir


def _reflect_l(wo_l):
    return torch.stack([-wo_l[..., 0], -wo_l[..., 1], wo_l[..., 2]], dim=-1)


def _specular_f(c, fr_term, wi_l):
    return c * (fr_term / torch.clamp(torch.abs(_cos_theta(wi_l)),
                                      min=1e-30))[..., None]


def bsdf_sample(mp: MatParams, si: Surface, wo_w, u, meta=None) -> BsdfSample:
    """Bsdf::sample_f over every lobe (bsdfs/mod.rs:150-222); families
    absent from ``meta.material_types`` are not built."""
    wo_l = to_local(si, wo_w)
    present = _present(meta)
    zero3 = torch.zeros_like(wo_l)
    zero1 = torch.zeros_like(wo_l[..., 0])

    # Matte: one diffuse lobe.
    if MAT_MATTE in present:
        wi_mat = cosine_sample_hemisphere(u)
        flip = torch.tensor([1.0, 1.0, -1.0], dtype=torch.float32,
                            device=wo_l.device)
        wi_mat = torch.where((wo_l[..., 2] < 0.0)[..., None], wi_mat * flip,
                             wi_mat)
        pdf_mat = torch.abs(_cos_theta(wi_mat)) * INV_PI
        f_mat = _matte_f(mp, wo_l, wi_mat, meta)
    else:
        wi_mat, pdf_mat, f_mat = zero3, zero1, zero3

    # Glass: two specular lobes, picked by u0.
    pick_refl = u[..., 0] < 0.5  # floor(u0 * 2) == 0
    if MAT_GLASS in present:
        wi_re = _reflect_l(wo_l)
        f_re = _specular_f(mp.c0, fresnel_dielectric(_cos_theta(wi_re), 1.0,
                                                     mp.s0), wi_re)
        wi_tr, tir = _refract_l(wo_l, mp.s0)
        fr_tr = fresnel_dielectric(_cos_theta(wi_tr), 1.0, mp.s0)
        f_tr = torch.where(tir[..., None], 0.0,
                           _specular_f(mp.c1, 1.0 - fr_tr, wi_tr))
        wi_gl = torch.where(pick_refl[..., None], wi_re, wi_tr)
        f_gl = torch.where(pick_refl[..., None], f_re, f_tr)
        # pdf 1 over the two matching components.
        pdf_gl = torch.where(pick_refl | ~tir, 0.5, 0.0)
    else:
        tir = torch.zeros_like(pick_refl)
        wi_gl, f_gl, pdf_gl = zero3, zero3, zero1

    # Microfacet: metal and glossy.
    if MAT_METAL in present or MAT_GLOSSY in present:
        alpha = mp.alpha
        wh = ggx_sample_wh(wo_l, u, alpha)
        wo_wh = dot(wo_l, wh)
        wi_mf = -wo_l + wh * (2.0 * wo_wh)[..., None]
        mf_valid = ((wo_l[..., 2] != 0.0) & (wo_wh >= 0.0)
                    & _same_hemisphere(wo_l, wi_mf))
        pdf_mf = ggx_pdf(wh, alpha) / torch.clamp(4.0 * wo_wh, min=1e-30)
        f_mf = _microfacet_f(wo_l, wi_mf, alpha,
                             _microfacet_fresnel(mp, wo_l, wi_mf))
        pdf_mf = torch.where(mf_valid, pdf_mf, 0.0)
        f_mf = torch.where(mf_valid[..., None], f_mf, 0.0)
    else:
        wi_mf, f_mf, pdf_mf = zero3, zero3, zero1

    is_matte = mp.mtype == MAT_MATTE
    is_glass = mp.mtype == MAT_GLASS
    m3, g3 = is_matte[..., None], is_glass[..., None]
    wi_l = torch.where(m3, wi_mat, torch.where(g3, wi_gl, wi_mf))
    f = torch.where(m3, f_mat, torch.where(g3, f_gl, f_mf))
    pdf = torch.where(is_matte, pdf_mat, torch.where(is_glass, pdf_gl,
                                                     pdf_mf))
    return BsdfSample(wi=to_world(si, wi_l), f=f, pdf=pdf,
                      is_specular=is_glass,
                      is_transmission=is_glass & ~pick_refl & ~tir,
                      valid=pdf > 0.0)


def bsdf_sample_specular(mp: MatParams, si: Surface, wo_w,
                         transmission: bool) -> BsdfSample:
    """Bsdf::sample_f with SPECULAR|REFLECTION or SPECULAR|TRANSMISSION
    (whitted.rs:38-70): only glass lobes match; u is unused."""
    wo_l = to_local(si, wo_w)
    is_glass = mp.mtype == MAT_GLASS
    if not transmission:
        wi_l = _reflect_l(wo_l)
        f = _specular_f(mp.c0, fresnel_dielectric(_cos_theta(wi_l), 1.0,
                                                  mp.s0), wi_l)
        valid = is_glass
        is_trans = torch.zeros_like(is_glass)
    else:
        wi_l, tir = _refract_l(wo_l, mp.s0)
        fr = fresnel_dielectric(_cos_theta(wi_l), 1.0, mp.s0)
        f = _specular_f(mp.c1, 1.0 - fr, wi_l)
        valid = is_glass & ~tir
        is_trans = valid
    return BsdfSample(wi=to_world(si, wi_l),
                      f=torch.where(valid[..., None], f, 0.0),
                      pdf=torch.where(valid, 1.0, 0.0), is_specular=valid,
                      is_transmission=is_trans, valid=valid)
