"""Plain shading of the reference renderer: surface records, BSDFs,
light sampling and texture lookups, for every lane at once.

A frozen copy of the semantics of yuki's materials and lights (pbrt-v3's
Lambertian, Oren-Nayar, specular dielectric, conductor and Schlick
Fresnel, Torrance-Sparrow over Trowbridge-Reitz; point, spot, rectangle
and distant lights), written in plain PyTorch over a ``RefScene``
(``scene.py``).  Nothing here imports the program under test.  Every
function follows the dtype of the scene's tables.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .rmath import (apply_p, apply_v, const, coordinate_system,
                    cosine_sample_hemisphere, cross, dot, face_forward,
                    is_black, length, normalize_safe, recip, sqrt)

MAT_MATTE, MAT_GLASS, MAT_METAL, MAT_GLOSSY = 0, 1, 2, 3
LIGHT_POINT, LIGHT_SPOT, LIGHT_RECT, LIGHT_DISTANT = 0, 1, 2, 3
NO_SKIP = -2
INV_PI = 1.0 / math.pi


class Surface(NamedTuple):
    valid: torch.Tensor
    p: torch.Tensor
    n: torch.Tensor
    ns: torch.Tensor
    ss: torch.Tensor
    uv: torch.Tensor
    wo: torch.Tensor
    material: torch.Tensor  # int64
    area_light: torch.Tensor  # int64, -1 none


def _mat3(m, a, b, c, col=False):
    at = (lambda i, j: m[j, i]) if col else (lambda i, j: m[i, j])
    return torch.stack([at(i, 0) * a + at(i, 1) * b + at(i, 2) * c
                        for i in range(3)], dim=-1)


def _ray_to_object(m, o, d):
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    ro = torch.stack([m[i, 0] * ox + m[i, 1] * oy + m[i, 2] * oz + m[i, 3]
                      for i in range(3)], dim=-1)
    rd = torch.stack([m[i, 0] * dx + m[i, 1] * dy + m[i, 2] * dz
                      for i in range(3)], dim=-1)
    return ro, rd


def make_surface(sc, hit, o, d) -> Surface:
    """The shading record of each lane's winning primitive."""
    tri = sc.tri
    k = torch.clamp(hit.prim, min=0)
    p0, p1, p2 = tri.p0[k], tri.p1[k], tri.p2[k]
    n0, n1, n2 = tri.n0[k], tri.n1[k], tri.n2[k]
    uv0, uv1, uv2 = tri.uv0[k], tri.uv1[k], tri.uv2[k]
    has = tri.has_ns[k][..., None]
    swaps = tri.swaps[k][..., None]
    b0, b1 = hit.b0[..., None], hit.b1[..., None]
    b2 = 1.0 - b0 - b1
    p_tri = p0 * b0 + p1 * b1 + p2 * b2
    uv_tri = uv0 * b0 + uv1 * b1 + uv2 * b2
    dp02, dp12 = p0 - p2, p1 - p2
    duv02, duv12 = uv0 - uv2, uv1 - uv2
    uv_det = duv02[..., 0] * duv12[..., 1] - duv02[..., 1] * duv12[..., 0]
    degen = uv_det == 0.0
    inv_det = recip(torch.where(degen, 1.0, uv_det))
    dpdu = (dp02 * duv12[..., 1:2] - dp12 * duv02[..., 1:2]) * inv_det[..., None]
    cs_u, _ = coordinate_system(normalize_safe(cross(p2 - p0, p1 - p0)))
    dpdu = torch.where(degen[..., None], cs_u, dpdu)
    n_wind = normalize_safe(cross(dp02, dp12))
    n_wind = torch.where(swaps, -n_wind, n_wind)
    ns_raw = n0 * b0 + n1 * b1 + n2 * b2
    ns_ok = (dot(ns_raw, ns_raw) > 0.0)[..., None]
    ns_auth = torch.where(ns_ok, normalize_safe(ns_raw), n_wind)
    ss0 = normalize_safe(dpdu)
    ts_raw = cross(ss0, ns_auth)
    ts_ok = (dot(ts_raw, ts_raw) > 0.0)[..., None]
    ss_auth = cross(normalize_safe(ts_raw), ns_auth)
    cs_s, _ = coordinate_system(ns_auth)
    ss_auth = torch.where(ts_ok, ss_auth, cs_s)
    ns_tri = torch.where(has, ns_auth, n_wind)
    ss_tri = torch.where(has, ss_auth, ss0)
    n_tri = torch.where(has, face_forward(n_wind, ns_auth), n_wind)
    mat_tri, al_tri = tri.mat[k], tri.light[k]

    p_s, n_s, ss_s = p_tri.clone(), n_tri.clone(), ss_tri.clone()
    uv_s, mat_s = uv_tri.clone(), mat_tri.clone()
    sph = sc.sph
    theta_min, theta_max = math.pi, 0.0
    phi_max = 2.0 * math.pi
    for s in range(sph.radius.shape[0]):
        sel = hit.sphere == s
        w2o, o2w, radius = sph.w2o[s], sph.o2w[s], sph.radius[s]
        ro, rd = _ray_to_object(w2o, o, d)
        po = ro + rd * hit.t[..., None]
        po = po * (radius / torch.clamp(length(po), min=1e-20))[..., None]
        fix = (po[..., 0] == 0.0) & (po[..., 1] == 0.0)
        px_ = torch.where(fix, 1e-5 * radius, po[..., 0])
        py_, pz_ = po[..., 1], po[..., 2]
        phi = torch.atan2(py_, px_)
        phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
        u = phi / const(phi_max, phi)
        theta = torch.acos(torch.clamp(pz_ / radius, -1.0, 1.0))
        v = (theta - theta_min) / const(theta_max - theta_min, theta)
        dpdu_o = torch.stack([-phi_max * py_, phi_max * px_,
                              torch.zeros_like(phi)], dim=-1)
        inv_zr = recip(torch.clamp(sqrt(px_ * px_ + py_ * py_), min=1e-20))
        dpdv_o = torch.stack([pz_ * px_ * inv_zr, pz_ * py_ * inv_zr,
                              -radius * torch.sin(theta)],
                             dim=-1) * (theta_max - theta_min)
        n_obj = normalize_safe(cross(dpdu_o, dpdv_o))
        n_obj = torch.where(sph.swaps[s], -n_obj, n_obj)
        p_w = _mat3(o2w, px_, py_, pz_) + o2w[:3, 3]
        n_w = normalize_safe(_mat3(w2o, n_obj[..., 0], n_obj[..., 1],
                                   n_obj[..., 2], col=True))
        dpdu_w = _mat3(o2w, dpdu_o[..., 0], dpdu_o[..., 1], dpdu_o[..., 2])
        s3 = sel[..., None]
        p_s = torch.where(s3, p_w, p_s)
        n_s = torch.where(s3, n_w, n_s)
        ss_s = torch.where(s3, normalize_safe(dpdu_w), ss_s)
        uv_s = torch.where(s3, torch.stack([u, v], dim=-1), uv_s)
        mat_s = torch.where(sel, sph.mat[s], mat_s)
    on = (hit.sphere >= 0)
    o3 = on[..., None]
    return Surface(valid=hit.hit, p=torch.where(o3, p_s, p_tri),
                   n=torch.where(o3, n_s, n_tri),
                   ns=torch.where(o3, n_s, ns_tri),
                   ss=torch.where(o3, ss_s, ss_tri),
                   uv=torch.where(o3, uv_s, uv_tri), wo=-d,
                   material=torch.where(on, mat_s, mat_tri),
                   area_light=torch.where(on, -1, al_tri))


def spawn_ray(si: Surface, d_new):
    off = si.n * 1e-3
    side = (dot(d_new, si.n) > 0.0)[..., None]
    return torch.where(side, si.p + off, si.p - off)


def spawn_ray_to(si: Surface, target):
    off = si.n * 1e-3
    side = (dot(target - si.p, si.n) > 0.0)[..., None]
    o = torch.where(side, si.p + off, si.p - off)
    return o, target - o


# --- textures -------------------------------------------------------------------


def eval_texture(tex, tex_id, uv):
    """Point-sampled repeat-wrapped lookup with a y flip and the -0.5
    texel offset, truncated toward zero and clamped into the image."""
    w = tex.width[tex_id]
    h = tex.height[tex_id]
    off = tex.offset[tex_id]
    u, v = uv[..., 0].to(torch.float32), uv[..., 1].to(torch.float32)
    s = u - torch.floor(u)
    t = 1.0 - (v - torch.floor(v))
    x = s * w.to(torch.float32) - 0.5
    y = t * h.to(torch.float32) - 0.5
    xi = torch.minimum(torch.clamp(x.to(torch.int64), min=0), w - 1)
    yi = torch.minimum(torch.clamp(y.to(torch.int64), min=0), h - 1)
    return tex.texels[off + yi * w + xi]


# --- materials ------------------------------------------------------------------


class MatParams(NamedTuple):
    mtype: torch.Tensor
    c0: torch.Tensor
    c1: torch.Tensor
    s0: torch.Tensor
    alpha: torch.Tensor


def roughness_to_alpha(r):
    x = torch.log(torch.clamp(r, min=1e-3))
    return (1.62142 + 0.819955 * x + 0.1734 * x * x
            + 0.0171201 * x * x * x + 0.000640711 * x * x * x * x)


def gather_materials(sc, si: Surface) -> MatParams:
    m = sc.mat
    k = torch.clamp(si.material, min=0)
    mtype, c0, c1, s0 = m.mtype[k], m.c0[k], m.c1[k], m.s0[k]
    remap, tex0, tex1 = m.remap[k], m.tex0[k], m.tex1[k]
    c0 = torch.where((tex0 >= 0)[..., None],
                     eval_texture(sc.tex, torch.clamp(tex0, min=0), si.uv), c0)
    s0 = torch.where(tex1 >= 0, eval_texture(sc.tex, torch.clamp(tex1, min=0),
                                             si.uv)[..., 0], s0)
    rough = torch.where(remap, roughness_to_alpha(s0), s0)
    rough = torch.where(mtype == MAT_GLOSSY, rough * rough, rough)
    return MatParams(mtype=mtype, c0=c0, c1=c1, s0=s0,
                     alpha=torch.clamp(rough, min=1e-3))


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


def to_local(si, v):
    t = cross(si.ns, si.ss)
    return torch.stack([dot(v, si.ss), dot(v, t), dot(v, si.ns)], dim=-1)


def to_world(si, v):
    t = cross(si.ns, si.ss)
    return si.ss * v[..., 0:1] + t * v[..., 1:2] + si.ns * v[..., 2:3]


def fresnel_dielectric(cos_i, eta_i, eta_t):
    ci = torch.clamp(cos_i, -1.0, 1.0)
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
    return torch.where(tir, 1.0, 0.5 * (r_par * r_par + r_per * r_per))


def fresnel_conductor(cos_i, eta, k):
    ci = torch.clamp(torch.abs(cos_i), max=1.0)[..., None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    eta2, k2 = eta * eta, k * k
    t0 = eta2 - k2 - si2
    a2b2 = sqrt(torch.clamp(t0 * t0 + 4.0 * eta2 * k2, min=0.0))
    t1 = a2b2 + ci2
    a = sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-30)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-30)
    return 0.5 * (rp + rs)


def fresnel_schlick(cos_i, rs):
    ci = torch.clamp(cos_i, -1.0, 1.0)[..., None]
    m = 1.0 - ci
    p5 = m * m
    p5 = p5 * p5 * m
    return rs + (1.0 - rs) * p5


def ggx_d(wh, alpha):
    t2 = _tan2(wh)
    a2 = alpha * alpha
    c4 = _cos2(wh) * _cos2(wh)
    e = t2 / a2
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
    u0 = u[..., 0]
    tan2t = alpha * alpha * u0 / torch.clamp(1.0 - u0, min=1e-7)
    ct = recip(sqrt(1.0 + tan2t))
    phi = 2.0 * math.pi * u[..., 1]
    st = sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    wh = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)
    return torch.where(_same_hemisphere(wo, wh)[..., None], wh, -wh)


def _microfacet_f(wo_l, wi_l, alpha, fr):
    cto = torch.abs(wo_l[..., 2])
    cti = torch.abs(wi_l[..., 2])
    wh = wi_l + wo_l
    ok = torch.any(wh != 0.0, dim=-1) & (cto > 0.0) & (cti > 0.0)
    wh = normalize_safe(wh)
    dg = ggx_d(wh, alpha) * ggx_g(wo_l, wi_l, alpha)
    f = fr * (dg / torch.clamp(4.0 * cti * cto, min=1e-30))[..., None]
    return torch.where(ok[..., None], f, 0.0)


def _microfacet_fresnel(mp, wo_l, wi_l):
    wh = normalize_safe(wi_l + wo_l)
    wh = torch.where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    ci = dot(wi_l, wh)
    return torch.where((mp.mtype == MAT_METAL)[..., None],
                       fresnel_conductor(ci, mp.c0, mp.c1),
                       fresnel_schlick(ci, mp.c0))


def _matte_f(mp, wo_l, wi_l):
    lam = mp.c0 * INV_PI
    sigma2 = mp.s0 * mp.s0
    a = 1.0 - sigma2 / (2.0 * (sigma2 + 0.33))
    b = 0.45 * sigma2 / (sigma2 + 0.09)
    sti, sto = _sin_theta(wo_l), _sin_theta(wi_l)
    both = (sti > 1e-4) & (sto > 1e-4)
    d_cos = (_cs_phi(wo_l, 0) * _cs_phi(wi_l, 0)
             + _cs_phi(wo_l, 1) * _cs_phi(wi_l, 1))
    max_cos = torch.where(both, torch.clamp(d_cos, min=0.0), 0.0)
    cti, cto = torch.abs(wo_l[..., 2]), torch.abs(wi_l[..., 2])
    first = cti > cto
    sin_alpha = torch.where(first, sto, sti)
    tan_beta = torch.where(first, sti / torch.clamp(cti, min=1e-30),
                           sto / torch.clamp(cto, min=1e-30))
    on = mp.c0 * (INV_PI * (a + b * max_cos * sin_alpha * tan_beta))[..., None]
    f = torch.where((mp.s0 == 0.0)[..., None], lam, on)
    return torch.where(is_black(mp.c0)[..., None], 0.0, f)


def bsdf_f(mp, si, wo_w, wi_w):
    wo_l, wi_l = to_local(si, wo_w), to_local(si, wi_w)
    reflect = (dot(wi_w, si.n) * dot(wo_w, si.n)) > 0.0
    f = torch.zeros_like(mp.c0)
    f = torch.where((mp.mtype == MAT_MATTE)[..., None],
                    _matte_f(mp, wo_l, wi_l), f)
    fr = _microfacet_fresnel(mp, wo_l, wi_l)
    mf = (mp.mtype == MAT_METAL) | (mp.mtype == MAT_GLOSSY)
    f = torch.where(mf[..., None], _microfacet_f(wo_l, wi_l, mp.alpha, fr), f)
    return torch.where(reflect[..., None], f, 0.0)


class BsdfSample(NamedTuple):
    wi: torch.Tensor
    f: torch.Tensor
    pdf: torch.Tensor
    is_specular: torch.Tensor
    valid: torch.Tensor


def _refract_l(wo_l, s0):
    entering = wo_l[..., 2] > 0.0
    eta_i = torch.where(entering, 1.0, s0)
    eta_t = torch.where(entering, s0, 1.0)
    eta = eta_i / eta_t
    n_ff = torch.where(entering, 1.0, -1.0).to(wo_l.dtype)
    cti = n_ff * wo_l[..., 2]
    s2tt = eta * eta * torch.clamp(1.0 - cti * cti, min=0.0)
    tir = s2tt >= 1.0
    ctt = sqrt(torch.clamp(1.0 - s2tt, min=0.0))
    zero = torch.zeros_like(eta)
    wi_l = -wo_l * eta[..., None] + torch.stack(
        [zero, zero, n_ff], dim=-1) * (eta * cti - ctt)[..., None]
    return wi_l, tir


def _reflect_l(wo_l):
    return torch.stack([-wo_l[..., 0], -wo_l[..., 1], wo_l[..., 2]], dim=-1)


def _specular_f(c, fr, wi_l):
    return c * (fr / torch.clamp(torch.abs(wi_l[..., 2]), min=1e-30))[..., None]


def bsdf_sample(mp, si, wo_w, u) -> BsdfSample:
    wo_l = to_local(si, wo_w)
    wi_mat = cosine_sample_hemisphere(u)
    flip = torch.tensor([1.0, 1.0, -1.0], dtype=wo_l.dtype, device=wo_l.device)
    wi_mat = torch.where((wo_l[..., 2] < 0.0)[..., None], wi_mat * flip, wi_mat)
    pdf_mat = torch.abs(wi_mat[..., 2]) * INV_PI
    f_mat = _matte_f(mp, wo_l, wi_mat)

    pick_refl = u[..., 0] < 0.5
    wi_re = _reflect_l(wo_l)
    f_re = _specular_f(mp.c0, fresnel_dielectric(wi_re[..., 2], 1.0, mp.s0),
                       wi_re)
    wi_tr, tir = _refract_l(wo_l, mp.s0)
    fr_tr = fresnel_dielectric(wi_tr[..., 2], 1.0, mp.s0)
    f_tr = torch.where(tir[..., None], 0.0, _specular_f(mp.c1, 1.0 - fr_tr,
                                                         wi_tr))
    wi_gl = torch.where(pick_refl[..., None], wi_re, wi_tr)
    f_gl = torch.where(pick_refl[..., None], f_re, f_tr)
    pdf_gl = torch.where(pick_refl | ~tir, 0.5, 0.0).to(wo_l.dtype)

    alpha = mp.alpha
    wh = ggx_sample_wh(wo_l, u, alpha)
    wo_wh = dot(wo_l, wh)
    wi_mf = -wo_l + wh * (2.0 * wo_wh)[..., None]
    mf_ok = ((wo_l[..., 2] != 0.0) & (wo_wh >= 0.0)
             & _same_hemisphere(wo_l, wi_mf))
    pdf_mf = ggx_d(wh, alpha) * wh[..., 2] / torch.clamp(4.0 * wo_wh, min=1e-30)
    f_mf = _microfacet_f(wo_l, wi_mf, alpha, _microfacet_fresnel(mp, wo_l,
                                                                 wi_mf))
    pdf_mf = torch.where(mf_ok, pdf_mf, 0.0)
    f_mf = torch.where(mf_ok[..., None], f_mf, 0.0)

    is_matte, is_glass = mp.mtype == MAT_MATTE, mp.mtype == MAT_GLASS
    m3, g3 = is_matte[..., None], is_glass[..., None]
    wi_l = torch.where(m3, wi_mat, torch.where(g3, wi_gl, wi_mf))
    f = torch.where(m3, f_mat, torch.where(g3, f_gl, f_mf))
    pdf = torch.where(is_matte, pdf_mat, torch.where(is_glass, pdf_gl, pdf_mf))
    return BsdfSample(wi=to_world(si, wi_l), f=f, pdf=pdf,
                      is_specular=is_glass, valid=pdf > 0.0)


def bsdf_sample_specular(mp, si, wo_w, transmission: bool) -> BsdfSample:
    """The glass lobe of one kind only (Whitted's children)."""
    wo_l = to_local(si, wo_w)
    is_glass = mp.mtype == MAT_GLASS
    if not transmission:
        wi_l = _reflect_l(wo_l)
        f = _specular_f(mp.c0, fresnel_dielectric(wi_l[..., 2], 1.0, mp.s0),
                        wi_l)
        valid = is_glass
    else:
        wi_l, tir = _refract_l(wo_l, mp.s0)
        fr = fresnel_dielectric(wi_l[..., 2], 1.0, mp.s0)
        f = _specular_f(mp.c1, 1.0 - fr, wi_l)
        valid = is_glass & ~tir
    one = torch.ones_like(wo_l[..., 0])
    return BsdfSample(wi=to_world(si, wi_l),
                      f=torch.where(valid[..., None], f, 0.0),
                      pdf=torch.where(valid, one, 0.0), is_specular=valid,
                      valid=valid)


# --- lights ----------------------------------------------------------------------


class LightSample(NamedTuple):
    l: torch.Tensor
    li: torch.Tensor
    pdf: torch.Tensor
    target: torch.Tensor
    skip: torch.Tensor  # int64


def sample_light(sc, idx: int, si: Surface, u) -> LightSample:
    L = sc.lights[idx]
    shape = si.p.shape[:-1]
    dev = si.p.device
    ones = torch.ones(shape, dtype=si.p.dtype, device=dev)
    no_skip = torch.full(shape, NO_SKIP, dtype=torch.int64, device=dev)
    kind = L["type"]

    def toward(p):
        to_l = p - si.p
        d2 = torch.clamp(dot(to_l, to_l), min=1e-30)
        return to_l / sqrt(d2)[..., None], d2

    if kind == LIGHT_POINT:
        l, d2 = toward(L["p"])
        return LightSample(l, L["i"] / d2[..., None], ones,
                           L["p"].expand(si.p.shape), no_skip)
    if kind == LIGHT_SPOT:
        l, d2 = toward(L["p"])
        ct = normalize_safe(apply_v(L["m"], -l))[..., 2]
        cos_w, cos_f = L["cos_w"], L["cos_f"]
        delta = (ct - cos_w) / torch.clamp(cos_f - cos_w, min=1e-30)
        fall = torch.where(ct < cos_w, 0.0, torch.where(
            ct > cos_f, 1.0, (delta * delta) * (delta * delta)))
        return LightSample(l, L["i"] * (fall / d2)[..., None], ones,
                           L["p"].expand(si.p.shape), no_skip)
    if kind == LIGHT_RECT:
        s2w = L["m"]
        zeros = torch.zeros(shape, dtype=si.p.dtype, device=dev)
        p = apply_p(s2w, torch.stack([u[..., 0], zeros, u[..., 1]], dim=-1))
        down = torch.tensor([0.0, -1.0, 0.0], dtype=si.p.dtype, device=dev)
        n = normalize_safe(apply_v(s2w, down)).expand(si.p.shape)
        wi = normalize_safe(p - si.p)
        front = dot(n, -wi) > 0.0
        li = torch.where(front[..., None], L["i"], 0.0)
        dp = p - si.p
        pdf = dot(dp, dp) / torch.clamp(torch.abs(dot(n, -wi)) * L["area"],
                                        min=1e-30)
        return LightSample(wi, li, pdf, p, torch.full(
            shape, idx, dtype=torch.int64, device=dev))
    if kind == LIGHT_DISTANT:
        w = L["p"]
        ext = sc.world_hi - sc.world_lo
        diag = sqrt(dot(ext, ext)) * 1.002 + 1e-3
        return LightSample(w.expand(si.p.shape), L["i"].expand(si.p.shape),
                           ones, si.p + w * diag, no_skip)
    raise ValueError(f"unknown light type {kind}")


def area_light_radiance(sc, si: Surface, w):
    has = si.area_light >= 0
    le = sc.light_i[torch.clamp(si.area_light, min=0)]
    front = dot(si.n, w) > 0.0
    return torch.where((has & front)[..., None], le, 0.0)
