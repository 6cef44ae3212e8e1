"""Per-bounce shading: port of ``yuki_tpu/ops/shade_fused.py``.

``shade_body`` is the plain PyTorch port of ``_shade_body`` (:360-797)
and its helpers (:101-358) on flat [N] tensors.  It is the shading half
of the dense wave's plain bounce (``path_fused.bounce_plain``) and the
plain version of the treelet path's shade kernel; both CUDA kernels run
the same maths per thread (``shade_lane`` in ``csrc/path_fused.cuh``).
The formulas and their op order are ``yuki_tpu``'s:
  surface.make_surface          (triangle.rs:186-224, sphere.rs:91-150)
  bsdf.gather_materials tail    (matte.rs:22-41, trowbridge_reitz.rs:22-30)
  integrators._nee_setup        (path.rs:102-124)
  lights.sample_li (4 types)    (point/spot/rectangular/distant_light.rs)
  lights.area_light_radiance    (rectangular_light.rs:74-82)
  bsdf.bsdf_f / bsdf_sample     (bsdfs/mod.rs:125-222 + lobe files)
  path_li shade tail            (path.rs:126-178: beta, RR)

Like the JAX body it is specialised on the scene's static facts (light
types, material families present, sigma); a skipped lobe is one no lane
of the scene can select, so per-lane results do not depend on it.

Every division has a tensor divisor: on CUDA, torch turns ``tensor /
python_scalar`` into a multiply by the reciprocal, which is not the IEEE
quotient the JAX body and the CUDA kernel compute.

The treelet path's two kernels and the host code around them follow
``shade_body`` (the second half of this module):

  shade    replaces ``_shade_kernel`` (shade_fused.py:798), called by
           ``shade_fused`` (:1064-1292)
  resolve  replaces ``_resolve_kernel`` (:868), called by
           ``resolve_fused`` (:926-1030)

A CUDA tensor launches the kernel in ``csrc/shade_fused.cu`` or raises; a
CPU tensor runs the plain version (``shade_planes_plain``,
``resolve_planes_plain``).  Each kernel launch adds one to ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from . import _build
from ..sampling import MASK32, StratifiedSampler, UniformSampler
from ..vecmath import sqrt as _sqrt
from ..scene.data import (
    LIGHT_DISTANT,
    LIGHT_POINT,
    LIGHT_RECT,
    LIGHT_SPOT,
    MAT_GLASS,
    MAT_GLOSSY,
    MAT_MATTE,
    MAT_METAL,
)

INV_PI = 1.0 / math.pi

# The body's only transcendentals.  CUDA's libdevice, torch's CPU kernels
# and XLA each round them differently by up to an ulp; naming them once
# lets a test evaluate them one way on both sides and hold the rest of
# the arithmetic to rounding level.
_cos, _sin, _log = torch.cos, torch.sin, torch.log


# --------------------------------------------------------------------
# SoA vector helpers: vectors are (x, y, z) tuples of [N] tensors.
# --------------------------------------------------------------------


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _neg(a):
    return (-a[0], -a[1], -a[2])


def _where3(c, a, b):
    return (
        torch.where(c, a[0], b[0]),
        torch.where(c, a[1], b[1]),
        torch.where(c, a[2], b[2]),
    )


def _recip(x):
    """IEEE 1/x."""
    return torch.reciprocal(x)


def _normalize_safe(a):
    """vecmath.normalize_safe: v / max(|v|, 1e-20)."""
    l = _sqrt(_dot(a, a))
    inv = _recip(torch.clamp(l, min=1e-20))
    return _scale(a, inv)


def _length_sqr(a):
    return _dot(a, a)


def _coordinate_system(v1):
    """vecmath.coordinate_system (math/mod.rs:30 with the typo fix)."""
    ax, ay = torch.abs(v1[0]), torch.abs(v1[1])
    use_x = ax > ay
    inv_a = _recip(_sqrt(torch.clamp(v1[0] * v1[0] + v1[2] * v1[2],
                                          min=1e-40)))
    inv_b = _recip(_sqrt(torch.clamp(v1[1] * v1[1] + v1[2] * v1[2],
                                          min=1e-40)))
    zero = torch.zeros_like(v1[0])
    v2 = (
        torch.where(use_x, -v1[2] * inv_a, zero),
        torch.where(use_x, zero, v1[2] * inv_b),
        torch.where(use_x, v1[0] * inv_a, -v1[1] * inv_b),
    )
    return v2, _cross(v1, v2)


def _face_forward(n, v):
    flip = _dot(n, v) < 0.0
    return _where3(flip, _neg(n), n)


def _is_black(c):
    return (c[0] == 0.0) & (c[1] == 0.0) & (c[2] == 0.0)


# --------------------------------------------------------------------
# Stateless sampler on int64-held u32 lanes (sampling.py form).
# --------------------------------------------------------------------


def pcg(x: torch.Tensor) -> torch.Tensor:
    """pcg_hash on int64 tensors holding u32 values."""
    state = (x * 747796405 + 2891336453) & MASK32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def dim_f32(ph_base: torch.Tensor, dim: int) -> torch.Tensor:
    """u32_to_unit_float(pcg(ph_base ^ dim)); ph_base is the per-lane
    pcg(pixel_hash ^ sample_index) as an int64-held u32."""
    u = pcg(ph_base ^ (dim & MASK32))
    return (u >> 8).to(torch.float32) * (1.0 / (1 << 24))


# --------------------------------------------------------------------
# BSDF lobes on SoA local-frame tensors (bsdf.py port).
# --------------------------------------------------------------------


def _fresnel_dielectric(ct, eta_i, eta_t):
    ci = torch.clamp(ct, -1.0, 1.0)
    entering = ci > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(ci)
    si_ = _sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    st = ei / et * si_
    tir = st >= 1.0
    ctt = _sqrt(torch.clamp(1.0 - st * st, min=0.0))
    r_par = (et * ci - ei * ctt) / torch.clamp(et * ci + ei * ctt, min=1e-30)
    r_per = (ei * ci - et * ctt) / torch.clamp(ei * ci + et * ctt, min=1e-30)
    fr = 0.5 * (r_par * r_par + r_per * r_per)
    return torch.where(tir, 1.0, fr)


def _fresnel_conductor3(ct, eta, k):
    """Per-channel conductor Fresnel; eta/k are 3-tuples of tensors."""
    ci = torch.clamp(torch.abs(ct), max=1.0)
    ci2 = ci * ci
    si2 = 1.0 - ci2
    out = []
    for c in range(3):
        eta2 = eta[c] * eta[c]
        etak2 = k[c] * k[c]
        t0 = eta2 - etak2 - si2
        a2b2 = _sqrt(torch.clamp(t0 * t0 + 4.0 * eta2 * etak2, min=0.0))
        t1 = a2b2 + ci2
        a = _sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
        t2 = 2.0 * a * ci
        rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-30)
        t3 = ci2 * a2b2 + si2 * si2
        t4 = t2 * si2
        rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-30)
        out.append(0.5 * (rp + rs))
    return tuple(out)


def _fresnel_schlick3(ct, rs):
    ci = torch.clamp(ct, -1.0, 1.0)
    p5 = (1.0 - ci) * (1.0 - ci)
    p5 = p5 * p5 * (1.0 - ci)
    return tuple(rs[c] + (1.0 - rs[c]) * p5 for c in range(3))


def _cos2(w):
    return w[2] * w[2]


def _sin2(w):
    return torch.clamp(1.0 - _cos2(w), min=0.0)


def _tan2(w):
    c2 = _cos2(w)
    return _sin2(w) / torch.where(c2 == 0.0, 1e-30, c2)


def _ggx_d(wh, alpha):
    t2 = _tan2(wh)
    a2 = alpha * alpha
    c4 = _cos2(wh) * _cos2(wh)
    e = t2 / a2
    val = _recip(math.pi * a2 * c4 * (1.0 + e) * (1.0 + e))
    return torch.where(torch.isfinite(t2) & (c4 > 0.0), val, 0.0)


def _ggx_lambda(w, alpha):
    abs_tan = _sqrt(torch.clamp(_tan2(w), min=0.0))
    at = alpha * abs_tan
    a2t2 = at * at
    lam = (-1.0 + _sqrt(1.0 + a2t2)) * 0.5
    return torch.where(torch.isfinite(abs_tan), lam, 0.0)


def _ggx_g(wo, wi, alpha):
    return _recip(1.0 + _ggx_lambda(wo, alpha) + _ggx_lambda(wi, alpha))


def _microfacet_fresnel(has_metal, has_glossy, mtype, c0, c1, wo_l, wi_l):
    wh = _normalize_safe(_add(wi_l, wo_l))
    wh = _where3(wh[2] < 0.0, _neg(wh), wh)
    ci = _dot(wi_l, wh)
    if has_metal and has_glossy:
        fr_m = _fresnel_conductor3(ci, c0, c1)
        fr_g = _fresnel_schlick3(ci, c0)
        return _where3(mtype == MAT_METAL, fr_m, fr_g)
    if has_metal:
        return _fresnel_conductor3(ci, c0, c1)
    return _fresnel_schlick3(ci, c0)


def _microfacet_f(wo_l, wi_l, alpha, fr):
    cto = torch.abs(wo_l[2])
    cti = torch.abs(wi_l[2])
    wh_raw = _add(wi_l, wo_l)
    wh_ok = (
        ((wh_raw[0] != 0.0) | (wh_raw[1] != 0.0) | (wh_raw[2] != 0.0))
        & (cto > 0.0)
        & (cti > 0.0)
    )
    wh = _normalize_safe(wh_raw)
    d = _ggx_d(wh, alpha)
    g = _ggx_g(wo_l, wi_l, alpha)
    denom = torch.clamp(4.0 * cti * cto, min=1e-30)
    s = d * g / denom
    return tuple(torch.where(wh_ok, fr[c] * s, 0.0) for c in range(3))


def _matte_f(has_sigma, kd, s0, wo_l, wi_l):
    lam = _scale(kd, torch.full_like(kd[0], INV_PI))
    if not has_sigma:
        f = lam
    else:
        sigma2 = s0 * s0
        a = 1.0 - sigma2 / (2.0 * (sigma2 + 0.33))
        b = 0.45 * sigma2 / (sigma2 + 0.09)
        sti = _sqrt(_sin2(wo_l))
        sto = _sqrt(_sin2(wi_l))

        def cos_phi(w, st):
            return torch.where(
                st == 0.0, 1.0,
                torch.clamp(w[0] / torch.where(st == 0, 1.0, st), -1.0, 1.0),
            )

        def sin_phi(w, st):
            return torch.where(
                st == 0.0, 1.0,
                torch.clamp(w[1] / torch.where(st == 0, 1.0, st), -1.0, 1.0),
            )

        both = (sti > 1e-4) & (sto > 1e-4)
        d_cos = cos_phi(wo_l, sti) * cos_phi(wi_l, sto) + sin_phi(
            wo_l, sti
        ) * sin_phi(wi_l, sto)
        max_cos = torch.where(both, torch.clamp(d_cos, min=0.0), 0.0)
        cti = torch.abs(wo_l[2])
        cto = torch.abs(wi_l[2])
        first = cti > cto
        sin_alpha = torch.where(first, sto, sti)
        tan_beta = torch.where(
            first, sti / torch.clamp(cti, min=1e-30),
            sto / torch.clamp(cto, min=1e-30),
        )
        on_s = INV_PI * (a + b * max_cos * sin_alpha * tan_beta)
        on = _scale(kd, on_s)
        f = _where3(s0 == 0.0, lam, on)
    zero = torch.zeros_like(kd[0])
    return _where3(_is_black(kd), (zero, zero, zero), f)


# --------------------------------------------------------------------
# The shading body
# --------------------------------------------------------------------


def shade_body(dim0, bounce, rh, tr, mp, ltab, spm, center, diag, ph_base,
               *, n_lights, light_types, n_spheres, present, has_sigma,
               urand=None):
    """The per-bounce shading chain on [N] tensors (reader-callback form,
    as in yuki_tpu):
      rh(name)   -> ray/hit/carry tensor (ox..dz, t, b0, b1, sph, alive,
                    bx, by, bz, spec)
      tr(i)      -> triangle shading-row column i per lane
      mp(name)   -> material tensor (mtype, kdx.., c1x.., s0, remap; kd
                    already texture-resolved)
      ltab(li,i) -> light-table scalar, spm(s,i) -> sphere-table scalar
      center (3 scalars) / diag: scene bounds for ray parking
    ``dim0`` and ``bounce`` are Python ints; random numbers are the
    UniformSampler's ``dim_f32(ph_base, dim0 + k)``, or ``urand(k)`` where
    given (a StratifiedSampler's planes, k = 0 .. 2L+2).
    Returns (o2, d2, beta2, alive2, spec2, ne, nee) where nee is a
    per-light list of (o_s, d_s, t_s, worth, contrib)."""

    if urand is None:
        def urand(k):
            return dim_f32(ph_base, dim0 + k)

    o = (rh("ox"), rh("oy"), rh("oz"))
    d = (rh("dx"), rh("dy"), rh("dz"))
    wo = _neg(d)
    t_hit = rh("t")
    b0 = rh("b0")
    b1 = rh("b1")
    sph = rh("sph")
    alive = rh("alive") > 0.0
    beta = (rh("bx"), rh("by"), rh("bz"))
    zero = torch.zeros_like(b0)
    one = torch.ones_like(b0)

    # ---- triangle surface (surface.make_surface port) ----------------
    p0 = (tr(0), tr(1), tr(2))
    p1 = (tr(3), tr(4), tr(5))
    p2 = (tr(6), tr(7), tr(8))
    n0 = (tr(9), tr(10), tr(11))
    n1 = (tr(12), tr(13), tr(14))
    n2 = (tr(15), tr(16), tr(17))
    uv0 = (tr(18), tr(19))
    uv1 = (tr(20), tr(21))
    uv2 = (tr(22), tr(23))
    has_ns = tr(24) > 0.5
    swaps = tr(25) > 0.5
    area_light = tr(27)  # f32 id, -1 none
    b2 = 1.0 - b0 - b1

    p_tri = _add(_add(_scale(p0, b0), _scale(p1, b1)), _scale(p2, b2))

    dp02 = _sub(p0, p2)
    dp12 = _sub(p1, p2)
    duv02 = (uv0[0] - uv2[0], uv0[1] - uv2[1])
    duv12 = (uv1[0] - uv2[0], uv1[1] - uv2[1])
    uv_det = duv02[0] * duv12[1] - duv02[1] * duv12[0]
    degen_uv = uv_det == 0.0
    inv_uv_det = _recip(torch.where(degen_uv, 1.0, uv_det))
    dpdu = _scale(
        _sub(_scale(dp02, duv12[1]), _scale(dp12, duv02[1])), inv_uv_det
    )
    n_fallback = _normalize_safe(_cross(_sub(p2, p0), _sub(p1, p0)))
    cs_u, _ = _coordinate_system(n_fallback)
    dpdu = _where3(degen_uv, cs_u, dpdu)

    n_wind = _normalize_safe(_cross(dp02, dp12))
    n_wind = _where3(swaps, _neg(n_wind), n_wind)

    ns_raw = _add(_add(_scale(n0, b0), _scale(n1, b1)), _scale(n2, b2))
    ns_ok = _length_sqr(ns_raw) > 0.0
    ns_auth = _where3(ns_ok, _normalize_safe(ns_raw), n_wind)
    ss0 = _normalize_safe(dpdu)
    ts_raw = _cross(ss0, ns_auth)
    ts_ok = _length_sqr(ts_raw) > 0.0
    ts_n = _normalize_safe(ts_raw)
    ss_auth = _cross(ts_n, ns_auth)
    cs_s, _ = _coordinate_system(ns_auth)
    ss_auth = _where3(ts_ok, ss_auth, cs_s)
    ns_tri = _where3(has_ns, ns_auth, n_wind)
    ss_tri = _where3(has_ns, ss_auth, ss0)
    n_tri = _where3(has_ns, _face_forward(n_wind, ns_auth), n_wind)

    # ---- sphere surface (no uv: sphere materials are untextured) -----
    s_p, s_n_, s_ss = p_tri, n_tri, ss_tri
    for s in range(n_spheres):
        sel = sph == float(s)

        def m(i, _s=s):  # w2o 0..15, o2w 16..31, radius 32, swaps 33
            return spm(_s, i)

        ro = (
            m(0) * o[0] + m(1) * o[1] + m(2) * o[2] + m(3),
            m(4) * o[0] + m(5) * o[1] + m(6) * o[2] + m(7),
            m(8) * o[0] + m(9) * o[1] + m(10) * o[2] + m(11),
        )
        rd = (
            m(0) * d[0] + m(1) * d[1] + m(2) * d[2],
            m(4) * d[0] + m(5) * d[1] + m(6) * d[2],
            m(8) * d[0] + m(9) * d[1] + m(10) * d[2],
        )
        radius = m(32)
        p_obj = _add(ro, _scale(rd, t_hit))
        scale_fix = radius / torch.clamp(_sqrt(_length_sqr(p_obj)),
                                         min=1e-20)
        p_obj = _scale(p_obj, scale_fix)
        fix = (p_obj[0] == 0.0) & (p_obj[1] == 0.0)
        px_ = torch.where(fix, 1e-5 * radius, p_obj[0])
        py_ = p_obj[1]
        pz_ = p_obj[2]
        dpdu_o = (-py_ * (2.0 * math.pi), px_ * (2.0 * math.pi),
                  torch.zeros_like(px_))
        n_obj = _normalize_safe((px_, py_, pz_))
        n_obj = _where3(m(33) > 0.5, _neg(n_obj), n_obj)
        p_w = (
            m(16) * px_ + m(17) * py_ + m(18) * pz_ + m(19),
            m(20) * px_ + m(21) * py_ + m(22) * pz_ + m(23),
            m(24) * px_ + m(25) * py_ + m(26) * pz_ + m(27),
        )
        # normals by w2o^T
        n_w = _normalize_safe((
            m(0) * n_obj[0] + m(4) * n_obj[1] + m(8) * n_obj[2],
            m(1) * n_obj[0] + m(5) * n_obj[1] + m(9) * n_obj[2],
            m(2) * n_obj[0] + m(6) * n_obj[1] + m(10) * n_obj[2],
        ))
        dpdu_w = (
            m(16) * dpdu_o[0] + m(17) * dpdu_o[1] + m(18) * dpdu_o[2],
            m(20) * dpdu_o[0] + m(21) * dpdu_o[1] + m(22) * dpdu_o[2],
            m(24) * dpdu_o[0] + m(25) * dpdu_o[1] + m(26) * dpdu_o[2],
        )
        s_p = _where3(sel, p_w, s_p)
        s_n_ = _where3(sel, n_w, s_n_)
        s_ss = _where3(sel, _normalize_safe(dpdu_w), s_ss)

    is_sph = sph >= 0.0
    p = _where3(is_sph, s_p, p_tri)
    n = _where3(is_sph, s_n_, n_tri)
    ns = _where3(is_sph, s_n_, ns_tri)
    ss = _where3(is_sph, s_ss, ss_tri)
    area_light = torch.where(is_sph, -1.0, area_light)
    ts_frame = _cross(ns, ss)  # Surface.frame_t

    # ---- materials (gather tail: alpha resolve) -----------------------
    mtype = mp("mtype").to(torch.int32)
    kd = (mp("kdx"), mp("kdy"), mp("kdz"))
    c1 = (mp("c1x"), mp("c1y"), mp("c1z"))
    s0 = mp("s0")
    remap = mp("remap") > 0.5
    x = _log(torch.clamp(s0, min=1e-3))
    r2a = (
        1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x * x * x
        + 0.000640711 * x * x * x * x
    )
    rough = torch.where(remap, r2a, s0)
    rough = torch.where(mtype == MAT_GLOSSY, rough * rough, rough)
    alpha = torch.clamp(rough, min=1e-3)

    def bsdf_f(wi_w):
        wo_l = (_dot(wo, ss), _dot(wo, ts_frame), _dot(wo, ns))
        wi_l = (_dot(wi_w, ss), _dot(wi_w, ts_frame), _dot(wi_w, ns))
        reflect = (_dot(wi_w, n) * _dot(wo, n)) > 0.0
        f = (zero, zero, zero)
        if MAT_MATTE in present:
            f = _where3(mtype == MAT_MATTE,
                        _matte_f(has_sigma, kd, s0, wo_l, wi_l), f)
        if (MAT_METAL in present) or (MAT_GLOSSY in present):
            fr = _microfacet_fresnel(
                MAT_METAL in present, MAT_GLOSSY in present, mtype, kd,
                c1, wo_l, wi_l,
            )
            fmf = _microfacet_f(wo_l, wi_l, alpha, fr)
            f = _where3((mtype == MAT_METAL) | (mtype == MAT_GLOSSY), fmf, f)
        return _where3(reflect, f, (zero, zero, zero))

    # ---- NEE setup per light ------------------------------------------
    nee = []
    for li_idx in range(n_lights):
        ltype = light_types[li_idx]
        u0 = urand(2 * li_idx)
        u1 = urand(2 * li_idx + 1)

        def lt(i, _li=li_idx):
            return ltab(_li, i)

        # light row: p 1..3; i 4..6; m 7..22 (row-major 4x4); area 23;
        # cos_w 24; cos_f 25
        l_i = (lt(4), lt(5), lt(6))
        if ltype == LIGHT_POINT:
            lp = (lt(1), lt(2), lt(3))
            to_l = _sub(lp, p)
            d2 = torch.clamp(_dot(to_l, to_l), min=1e-30)
            li_v = _scale(l_i, _recip(d2))
            l_dir = _scale(to_l, _recip(_sqrt(d2)))
            pdf = one
            target = (lp[0] + zero, lp[1] + zero, lp[2] + zero)
        elif ltype == LIGHT_SPOT:
            lp = (lt(1), lt(2), lt(3))
            to_l = _sub(lp, p)
            d2 = torch.clamp(_dot(to_l, to_l), min=1e-30)
            l_dir = _scale(to_l, _recip(_sqrt(d2)))
            nl = _neg(l_dir)
            dl = _normalize_safe((
                lt(7) * nl[0] + lt(8) * nl[1] + lt(9) * nl[2],
                lt(11) * nl[0] + lt(12) * nl[1] + lt(13) * nl[2],
                lt(15) * nl[0] + lt(16) * nl[1] + lt(17) * nl[2],
            ))
            ct = dl[2]
            cos_w, cos_f = lt(24), lt(25)
            delta = (ct - cos_w) / torch.clamp(cos_f - cos_w, min=1e-30)
            fall = torch.where(
                ct < cos_w, 0.0,
                torch.where(ct > cos_f, 1.0, (delta * delta) * (delta * delta)),
            )
            li_v = _scale(l_i, fall / d2)
            pdf = one
            target = (lp[0] + zero, lp[1] + zero, lp[2] + zero)
        elif ltype == LIGHT_RECT:
            # p_s = s2w @ (u0, 0, u1)
            ps = (
                lt(7) * u0 + lt(9) * u1 + lt(10),
                lt(11) * u0 + lt(13) * u1 + lt(14),
                lt(15) * u0 + lt(17) * u1 + lt(18),
            )
            # normal = normalize(s2w_linear @ (0,-1,0)) — per-light const
            nln = _sqrt(torch.clamp(
                lt(8) * lt(8) + lt(12) * lt(12) + lt(16) * lt(16), min=1e-40
            ))
            ln = (-lt(8) / nln + zero, -lt(12) / nln + zero,
                  -lt(16) / nln + zero)
            wi_ = _normalize_safe(_sub(ps, p))
            ndw = _dot(ln, _neg(wi_))
            front = ndw > 0.0
            li_v = _where3(front, l_i, (zero, zero, zero))
            d2 = _dot(_sub(ps, p), _sub(ps, p))
            pdf = d2 / torch.clamp(torch.abs(ndw) * lt(23), min=1e-30)
            l_dir = wi_
            target = ps
        elif ltype == LIGHT_DISTANT:
            w_dir = (lt(1), lt(2), lt(3))
            li_v = (l_i[0] + zero, l_i[1] + zero, l_i[2] + zero)
            l_dir = (w_dir[0] + zero, w_dir[1] + zero, w_dir[2] + zero)
            pdf = one
            target = _add(p, _scale(l_dir, diag))
        else:
            raise ValueError(f"unknown light type {ltype}")

        f_nee = bsdf_f(l_dir)
        cos_ = torch.clamp(_dot(ns, l_dir), 0.0, 1.0)
        worth = (
            alive
            & ~_is_black(li_v)
            & ~_is_black(f_nee)
            & (cos_ > 0.0)
        )
        # spawn_ray_to: offset along +-geometric n toward target
        off = _scale(n, torch.full_like(b0, 1e-3))
        side = _dot(_sub(target, p), n) > 0.0
        o_s = _where3(side, _add(p, off), _sub(p, off))
        d_s = _sub(target, o_s)
        o_s = _where3(worth, o_s, center)
        d_s = _where3(worth, d_s, (zero, zero, one))
        t_s = torch.where(worth, 0.9999, 0.0)
        contrib = tuple(
            f_nee[c] * li_v[c] * (cos_ / torch.clamp(pdf, min=1e-30))
            for c in range(3)
        )
        nee.append((o_s, d_s, t_s, worth, contrib))

    # ---- emitted (area_light_radiance, one-hot over L lights) --------
    emit_mask = rh("spec") > 0.0
    if bounce == 0:
        emit_mask = torch.ones_like(emit_mask)
    le = (zero, zero, zero)
    for li_idx in range(n_lights):
        sel = area_light == float(li_idx)
        le = _where3(
            sel,
            (ltab(li_idx, 4) + zero, ltab(li_idx, 5) + zero,
             ltab(li_idx, 6) + zero),
            le,
        )
    front_e = _dot(n, wo) > 0.0
    has_al = area_light >= 0.0
    emitted = _where3(has_al & front_e, le, (zero, zero, zero))
    ne = _where3(
        emit_mask,
        (beta[0] * emitted[0], beta[1] * emitted[1], beta[2] * emitted[2]),
        (zero, zero, zero),
    )

    # ---- bsdf_sample --------------------------------------------------
    u0 = urand(2 * n_lights)
    u1 = urand(2 * n_lights + 1)
    wo_l = (_dot(wo, ss), _dot(wo, ts_frame), _dot(wo, ns))

    has_matte = MAT_MATTE in present
    has_glass = MAT_GLASS in present
    has_micro = (MAT_METAL in present) or (MAT_GLOSSY in present)

    if has_matte:
        # cosine_sample_hemisphere(u) via concentric disk
        ox_ = u0 * 2.0 - 1.0
        oy_ = u1 * 2.0 - 1.0
        degen = (ox_ == 0.0) & (oy_ == 0.0)
        ox_s = torch.where(ox_ == 0.0, 1.0, ox_)
        oy_s = torch.where(oy_ == 0.0, 1.0, oy_)
        use_x = torch.abs(ox_) > torch.abs(oy_)
        theta = torch.where(
            use_x,
            (math.pi / 4.0) * (oy_ / ox_s),
            (math.pi / 2.0) - (math.pi / 4.0) * (ox_ / oy_s),
        )
        r_ = torch.where(use_x, ox_, oy_)
        dx_ = torch.where(degen, 0.0, _cos(theta) * r_)
        dy_ = torch.where(degen, 0.0, _sin(theta) * r_)
        z_ = _sqrt(torch.clamp(1.0 - dx_ * dx_ - dy_ * dy_, min=0.0))
        wi_mat = (dx_, dy_, z_)
        wi_mat = _where3(wo_l[2] < 0.0, (dx_, dy_, -z_), wi_mat)
        pdf_mat = torch.abs(wi_mat[2]) * INV_PI
        f_mat = _matte_f(has_sigma, kd, s0, wo_l, wi_mat)
    else:
        wi_mat, pdf_mat, f_mat = (zero, zero, zero), zero, (zero, zero, zero)

    pick_refl = u0 < 0.5
    if has_glass:
        wi_re = (-wo_l[0], -wo_l[1], wo_l[2])
        ct_re = wi_re[2]
        fr_re = _fresnel_dielectric(ct_re, one, s0)
        sc_re = fr_re / torch.clamp(torch.abs(ct_re), min=1e-30)
        f_re = _scale(kd, sc_re)
        entering = wo_l[2] > 0.0
        eta_i = torch.where(entering, 1.0, s0)
        eta_t = torch.where(entering, s0, 1.0)
        eta = eta_i / eta_t
        n_ff = torch.where(entering, 1.0, -1.0)
        cti = n_ff * wo_l[2]
        s2ti = torch.clamp(1.0 - cti * cti, min=0.0)
        s2tt = eta * eta * s2ti
        tir = s2tt >= 1.0
        ctt = _sqrt(torch.clamp(1.0 - s2tt, min=0.0))
        k_ = eta * cti - ctt
        wi_tr = (-wo_l[0] * eta, -wo_l[1] * eta, -wo_l[2] * eta + n_ff * k_)
        ct_tr = wi_tr[2]
        fr_tr = _fresnel_dielectric(ct_tr, one, s0)
        sc_tr = (1.0 - fr_tr) / torch.clamp(torch.abs(ct_tr), min=1e-30)
        f_tr = _scale(c1, sc_tr)
        f_tr = _where3(tir, (zero, zero, zero), f_tr)
        wi_gl = _where3(pick_refl, wi_re, wi_tr)
        f_gl = _where3(pick_refl, f_re, f_tr)
        gl_valid = pick_refl | ~tir
        pdf_gl = torch.where(gl_valid, 0.5, 0.0)
    else:
        wi_gl, f_gl, pdf_gl = (zero, zero, zero), (zero, zero, zero), zero

    if has_micro:
        # ggx_sample_wh (non-visible-area)
        tan2t = alpha * alpha * u0 / torch.clamp(1.0 - u0, min=1e-7)
        ct_h = _recip(_sqrt(1.0 + tan2t))
        phi_h = 2.0 * math.pi * u1
        st_h = _sqrt(torch.clamp(1.0 - ct_h * ct_h, min=0.0))
        wh = (st_h * _cos(phi_h), st_h * _sin(phi_h), ct_h)
        same_h = wo_l[2] * wh[2] > 0.0
        wh = _where3(same_h, wh, _neg(wh))
        dwh = _dot(wo_l, wh)
        wi_mf = _add(_neg(wo_l), _scale(wh, 2.0 * dwh))
        mf_valid = (
            (wo_l[2] != 0.0) & (dwh >= 0.0) & (wo_l[2] * wi_mf[2] > 0.0)
        )
        pdf_mf = (_ggx_d(wh, alpha) * wh[2]) / torch.clamp(4.0 * dwh,
                                                           min=1e-30)
        fr_mf = _microfacet_fresnel(
            MAT_METAL in present, MAT_GLOSSY in present, mtype, kd, c1,
            wo_l, wi_mf,
        )
        f_mf = _microfacet_f(wo_l, wi_mf, alpha, fr_mf)
        pdf_mf = torch.where(mf_valid, pdf_mf, 0.0)
        f_mf = _where3(mf_valid, f_mf, (zero, zero, zero))
    else:
        wi_mf, f_mf, pdf_mf = (zero, zero, zero), (zero, zero, zero), zero

    is_matte = mtype == MAT_MATTE
    is_glass = mtype == MAT_GLASS
    wi_l = _where3(is_matte, wi_mat, _where3(is_glass, wi_gl, wi_mf))
    f_s = _where3(is_matte, f_mat, _where3(is_glass, f_gl, f_mf))
    pdf = torch.where(is_matte, pdf_mat, torch.where(is_glass, pdf_gl, pdf_mf))
    spec2 = is_glass

    wi_w = (
        ss[0] * wi_l[0] + ts_frame[0] * wi_l[1] + ns[0] * wi_l[2],
        ss[1] * wi_l[0] + ts_frame[1] * wi_l[1] + ns[1] * wi_l[2],
        ss[2] * wi_l[0] + ts_frame[2] * wi_l[1] + ns[2] * wi_l[2],
    )

    terminated = _is_black(f_s) | (pdf == 0.0)
    alive2 = alive & ~terminated
    bscale = torch.abs(_dot(wi_w, ns)) / torch.clamp(pdf, min=1e-30)
    beta2 = tuple(beta[c] * f_s[c] * bscale for c in range(3))
    finite = (
        torch.isfinite(beta2[0]) & torch.isfinite(beta2[1])
        & torch.isfinite(beta2[2])
    )
    alive2 = alive2 & finite
    beta2 = _where3(finite, beta2, (zero, zero, zero))

    # spawn_ray + park
    off = _scale(n, torch.full_like(b0, 1e-3))
    side = _dot(wi_w, n) > 0.0
    o2 = _where3(side, _add(p, off), _sub(p, off))
    o2 = _where3(alive2, o2, center)
    d2v = _where3(alive2, wi_w, (zero, zero, one))

    # Russian roulette (after bounce 3).
    q = torch.clamp(1.0 - beta2[1], min=0.05)
    r_rr = urand(2 * n_lights + 2)
    if bounce > 3:
        alive2 = alive2 & ~(r_rr < q)
        inv_keep = _recip(torch.clamp(1.0 - q, min=1e-30))
        beta2 = _scale(beta2, inv_keep)

    return o2, d2v, beta2, alive2, spec2, ne, nee


# --------------------------------------------------------------------
# The treelet path's shade and resolve kernels: plane layouts
# (shade_fused.py:66-95)
# --------------------------------------------------------------------

# Shade input planes: the ray / hit / carry stack.
_RH = dict(
    ox=0, oy=1, oz=2, dx=3, dy=4, dz=5, t=6, b0=7, b1=8, sph=9,
    alive=10, bx=11, by=12, bz=13, spec=14, pad=15,
)
_N_RH = 16

# Material planes (kd/s0 texture-resolved), as shade_body reads them.
_MP = dict(mtype=0, kdx=1, kdy=2, kdz=3, c1x=4, c1y=5, c1z=6, s0=7,
           remap=8)

# Shade output planes; light li's planes start at
# _N_FIXED_OUT + _N_PER_LIGHT * li: o_s(3) d_s(3) t_s worth contrib(3) pad.
_OUT = dict(
    o2x=0, o2y=1, o2z=2, d2x=3, d2y=4, d2z=5,
    b2x=6, b2y=7, b2z=8, alive2=9, spec2=10,
    nex=11, ney=12, nez=13, pad0=14, pad1=15,
)
_N_FIXED_OUT = 16
_N_PER_LIGHT = 12

# Resolve input planes (shade_fused.py:870-875); the per-light verdict
# planes follow as [5L, N]: occ, cx, cy, cz, worth per light.
_RS = dict(
    rx=0, ry=1, rz=2, bx=3, by=4, bz=5, alive=6, missed=7,
    nex=8, ney=9, nez=10, bgx=11, bgy=12, bgz=13, clamp=14, pad=15,
)
_N_RS = 16
_N_NEE = 5

# Runtime flag bits of the shade kernel (the JAX kernel's statics).
FLAG_SIGMA = 1
FLAG_TEX = 4

# Kernel launches since the last reset_launches(); only the kernel
# branch of each wrapper counts.
LAUNCHES = {"shade": 0, "resolve": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fused_n_out(n_lights: int) -> int:
    return _N_FIXED_OUT + _N_PER_LIGHT * n_lights


# --------------------------------------------------------------------
# Tables and the gate
# --------------------------------------------------------------------


def light_table(lights) -> torch.Tensor:
    """[L,32] light rows: ltype, p(3), i(3), m(16), area, cos_w, cos_f."""
    n = lights.ltype.shape[0]
    z = torch.zeros((n, 6), dtype=torch.float32, device=lights.p.device)
    return torch.cat(
        [
            lights.ltype.to(torch.float32)[:, None],
            lights.p, lights.i, lights.m.reshape(-1, 16),
            lights.area[:, None], lights.cos_w[:, None],
            lights.cos_f[:, None], z,
        ],
        dim=1,
    ).contiguous()


def sphere_table(spheres, n_spheres: int, device) -> torch.Tensor:
    """[max(S,1),40] sphere rows: world_to_obj(16), obj_to_world(16),
    radius, swaps, material (the port adds the material id at 34)."""
    if not n_spheres:
        return torch.zeros((1, 40), dtype=torch.float32, device=device)
    return torch.cat(
        [
            spheres.world_to_obj.reshape(-1, 16),
            spheres.obj_to_world.reshape(-1, 16),
            spheres.radius[:, None],
            spheres.swaps_hand.to(torch.float32)[:, None],
            spheres.material.to(torch.float32)[:, None],
            torch.zeros((n_spheres, 5), dtype=torch.float32, device=device),
        ],
        dim=1,
    ).contiguous()


def scene_center_diag(data):
    """Scene centre (where dead lanes park) and the distant-light target
    distance: diag = |hi - lo| * 1.002 + 1e-3 (shade_fused.py:1209-1210)."""
    lo, hi = data.world_lo, data.world_hi
    ext = hi - lo
    diag = _sqrt(ext[0] * ext[0] + ext[1] * ext[1] + ext[2] * ext[2])
    return 0.5 * (lo + hi), diag * 1.002 + 1e-3


@dataclass
class ShadeTables:
    """What the shade and resolve kernels read besides the rays: the
    scene's shading tables on its device plus the statics the JAX kernels
    specialise on.  Built once per (scene, params) by
    ``make_shade_tables``."""

    trs: torch.Tensor  # [T,32] f32 shading rows
    mat: torch.Tensor  # [M,16] f32 material rows
    lt: torch.Tensor  # [L,32] f32 light rows
    sp: torch.Tensor  # [max(S,1),40] f32 sphere rows
    center: torch.Tensor  # [3] f32
    diag: torch.Tensor  # () f32
    center_diag: tuple  # the same four values as Python floats (kernel args)
    bg: torch.Tensor  # [3] f32 background radiance
    textures: object  # the scene's TextureAtlas
    n_spheres: int
    light_types: tuple
    present: frozenset
    has_sigma: bool
    has_textures: bool
    has_sigma_tex: bool
    indirect_clamp: object  # float or None

    @property
    def n_lights(self) -> int:
        return len(self.light_types)

    @property
    def device(self) -> torch.device:
        return self.trs.device

    @property
    def flags(self) -> int:
        return ((FLAG_SIGMA if self.has_sigma else 0)
                | (FLAG_TEX if self.has_textures else 0))


def make_shade_tables(scene, params) -> ShadeTables:
    data, meta = scene.data, scene.meta
    center, diag = scene_center_diag(data)
    return ShadeTables(
        trs=data.tris.shading_packed.contiguous(),
        mat=data.materials.packed.contiguous(),
        lt=light_table(data.lights),
        sp=sphere_table(data.spheres, meta.n_spheres, data.tris.p0.device),
        center=center, diag=diag,
        center_diag=tuple(center.tolist()) + (float(diag),),
        bg=data.background.to(torch.float32),
        textures=data.textures,
        n_spheres=meta.n_spheres,
        light_types=tuple(meta.light_types),
        present=frozenset(meta.material_types),
        has_sigma=bool(meta.has_sigma or meta.has_sigma_tex),
        has_textures=bool(meta.has_textures),
        has_sigma_tex=bool(meta.has_sigma_tex),
        indirect_clamp=params.indirect_clamp,
    )


def fused_shade_supported(meta, sampler) -> bool:
    """Static gate (shade_fused.py:1038-1061), from SceneMeta and the
    sampler only: every sphere's material must be untextured (the kernel
    skips sphere uv).  A StratifiedSampler's values reach the kernel as
    planes (``shade_fused``'s ``spl``)."""
    if not isinstance(sampler, (UniformSampler, StratifiedSampler)):
        return False
    return meta.n_spheres == 0 or meta.sphere_mats_untextured


# --------------------------------------------------------------------
# Shade: host side, plain version, kernel wrapper
# --------------------------------------------------------------------


def _gather_rows(tb: ShadeTables, prim, sph):
    """The triangle shading row at max(prim, 0) and the material row,
    spheres overriding the material (shade_fused.py:1108-1118)."""
    trow = tb.trs[torch.clamp(prim, min=0).to(torch.int64)]
    mid = trow[:, 26]
    for s in range(tb.n_spheres):
        mid = torch.where(sph == float(s), tb.sp[s, 34], mid)
    mrow = tb.mat[torch.clamp(mid, min=0.0).to(torch.int64)]
    return trow, mrow


def texture_planes(tb: ShadeTables, prim, sph, b0, b1):
    """kd and sigma resolved against the textures (shade_fused.py:1120-
    1138), as [4, N] planes kdx, kdy, kdz, s0; None without textures.
    Sphere lanes read garbage uv into lookups their untextured materials
    never use."""
    if not tb.has_textures:
        return None
    from ..textures import eval_texture

    trow, mrow = _gather_rows(tb, prim, sph)
    kd = mrow[:, 1:4]
    s0 = mrow[:, 7]
    b0c = b0[:, None]
    b1c = b1[:, None]
    b2c = 1.0 - b0c - b1c
    uv = trow[:, 18:20] * b0c + trow[:, 20:22] * b1c + trow[:, 22:24] * b2c
    tex0 = mrow[:, 9].to(torch.int32)
    tex_val = eval_texture(tb.textures, torch.clamp(tex0, min=0), uv)
    kd = torch.where((tex0 >= 0)[:, None], tex_val, kd)
    if tb.has_sigma_tex:
        tex1 = mrow[:, 10].to(torch.int32)
        s0_tex = eval_texture(tb.textures, torch.clamp(tex1, min=0), uv)[..., 0]
        s0 = torch.where(tex1 >= 0, s0_tex, s0)
    return torch.stack([kd[:, 0], kd[:, 1], kd[:, 2], s0]).contiguous()


def shade_planes_plain(tb: ShadeTables, rh, prim, ph, texp, dim0: int,
                       bounce: int, spl=None) -> torch.Tensor:
    """Plain version of the shade kernel: rh [16,N] (_RH), prim [N] i32,
    ph [N] i32 (pcg(pixel_hash ^ sample_index)), texp [4,N] or None,
    spl [2L+3,N] (a StratifiedSampler's values, in place of the hash) or
    None -> out [16 + 12L, N] (_OUT)."""
    trow, mrow = _gather_rows(tb, prim, rh[_RH["sph"]])
    mpd = {name: mrow[:, i] for name, i in _MP.items()}
    if texp is not None:
        mpd.update(kdx=texp[0], kdy=texp[1], kdz=texp[2], s0=texp[3])
    o2, d2v, beta2, alive2, spec2, ne, nee = shade_body(
        dim0, bounce,
        rh=lambda name: rh[_RH[name]],
        tr=lambda i: trow[:, i],
        mp=lambda name: mpd[name],
        ltab=lambda li, i: tb.lt[li, i],
        spm=lambda s, i: tb.sp[s, i],
        center=(tb.center[0], tb.center[1], tb.center[2]),
        diag=tb.diag,
        ph_base=ph.to(torch.int64) & MASK32,
        n_lights=tb.n_lights, light_types=tb.light_types,
        n_spheres=tb.n_spheres, present=tb.present, has_sigma=tb.has_sigma,
        urand=None if spl is None else spl.__getitem__,
    )
    zero = torch.zeros_like(o2[0])
    planes = [*o2, *d2v, *beta2, alive2.to(torch.float32),
              spec2.to(torch.float32), *ne, zero, zero]
    for o_s, d_s, t_s, worth, contrib in nee:
        planes += [*o_s, *d_s, t_s, worth.to(torch.float32), *contrib, zero]
    return torch.stack(planes)


def shade_planes(tb: ShadeTables, rh, prim, ph, texp, dim0: int,
                 bounce: int, spl=None) -> torch.Tensor:
    """The shade kernel on CUDA tensors, its plain version on CPU ones."""
    if not _build.dispatch(rh):
        return shade_planes_plain(tb, rh, prim, ph, texp, dim0, bounce, spl)
    dev = rh.device
    n = rh.shape[1]
    f32 = torch.float32
    _build.check(rh, "rh", f32, (_N_RH, n), dev)
    _build.check(prim, "prim", torch.int32, (n,), dev)
    _build.check(ph, "ph", torch.int32, (n,), dev)
    if tb.has_textures:
        _build.check(texp, "texp", f32, (4, n), dev)
    if spl is not None:
        _build.check(spl, "spl", f32, (2 * tb.n_lights + 3, n), dev)
    _build.check(tb.trs, "trs", f32, (tb.trs.shape[0], 32), dev)
    _build.check(tb.mat, "mat", f32, (tb.mat.shape[0], 16), dev)
    _build.check(tb.lt, "lt", f32, (tb.n_lights, 32), dev)
    _build.check(tb.sp, "sp", f32, (max(tb.n_spheres, 1), 40), dev)
    out = torch.empty((_fused_n_out(tb.n_lights), n), dtype=f32, device=dev)
    if n == 0:
        return out
    err = _build.library().yk_shade(
        dev.index, _build.ptr(rh), _build.ptr(prim), _build.ptr(ph),
        _build.ptr(texp) if tb.has_textures else None, n, int(dim0), int(bounce),
        _build.ptr(tb.trs), _build.ptr(tb.mat), _build.ptr(tb.lt), tb.n_lights, _build.ptr(tb.sp),
        tb.n_spheres, *tb.center_diag, tb.flags,
        None if spl is None else _build.ptr(spl), _build.ptr(out),
        _build.stream(dev),
    )
    _build.launch_check(err, "shade")
    LAUNCHES["shade"] += 1
    return out


def pack_shade(hit, o, d, beta, alive, specular_bounce):
    """The shade kernel's ray inputs: (rh [16,N] (_RH), prim [N] i32)."""
    n = o.shape[0]
    zero = torch.zeros(n, dtype=torch.float32, device=o.device)
    rh = torch.stack([
        o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
        hit.t, hit.b0, hit.b1, hit.sphere.to(torch.float32),
        alive.to(torch.float32), beta[:, 0], beta[:, 1], beta[:, 2],
        specular_bounce.to(torch.float32), zero,
    ])
    return rh, hit.prim.to(torch.int32).contiguous()


def shade_fused(tb: ShadeTables, hit, o, d, beta, alive, specular_bounce,
                ph, dim0: int, bounce: int, spl=None):
    """path_li's shading step (shade_fused.py:1064-1292): returns (o2, d2,
    beta2, alive2, spec2, no, nd, nt, ns_skip, nw, nc, ne) with the
    per-light NEE outputs flattened light-major; ``alive`` is the lanes
    alive and hitting.  ``spl``: a StratifiedSampler's 2L+3 values of the
    bounce as [2L+3, N] planes (shade_fused.py:1157-1170), None for the
    uniform sampler.  Torch does the plane packing and the texture
    resolve; the shade kernel does the rest."""
    n = o.shape[0]
    rh, prim = pack_shade(hit, o, d, beta, alive, specular_bounce)
    texp = texture_planes(tb, prim, rh[_RH["sph"]], hit.b0, hit.b1)
    out = shade_planes(tb, rh, prim, ph, texp, dim0, bounce, spl)

    def vec(i):
        return out[i:i + 3].t().contiguous()

    o2, d2, beta2 = vec(_OUT["o2x"]), vec(_OUT["d2x"]), vec(_OUT["b2x"])
    alive2 = out[_OUT["alive2"]] > 0.0
    spec2 = out[_OUT["spec2"]] > 0.0
    ne = vec(_OUT["nex"])
    obs = [_N_FIXED_OUT + _N_PER_LIGHT * li for li in range(tb.n_lights)]
    no = torch.cat([vec(ob) for ob in obs])
    nd = torch.cat([vec(ob + 3) for ob in obs])
    nt = torch.cat([out[ob + 6] for ob in obs])
    nw = torch.cat([out[ob + 7] > 0.0 for ob in obs])
    nc = torch.cat([vec(ob + 8) for ob in obs])
    # The skip id is static per light: rect lights skip themselves, -2
    # skips nothing (-1 would skip every ordinary triangle).
    ns_skip = torch.cat([
        torch.full((n,), li if lt == LIGHT_RECT else -2, dtype=torch.int32,
                   device=o.device)
        for li, lt in enumerate(tb.light_types)
    ])
    return o2, d2, beta2, alive2, spec2, no, nd, nt, ns_skip, nw, nc, ne


# --------------------------------------------------------------------
# Resolve: host side, plain version, kernel wrapper
# --------------------------------------------------------------------


def resolve_planes_plain(rs, nee, n_lights: int, bounce: int,
                         has_clamp: bool) -> torch.Tensor:
    """Plain version of the resolve kernel: rs [16,N] (_RS), nee [5L,N]
    -> out [4,N] (radiance xyz, pad), in _resolve_kernel's select/add
    order (shade_fused.py:876-923)."""
    rad = (rs[_RS["rx"]], rs[_RS["ry"]], rs[_RS["rz"]])
    beta = (rs[_RS["bx"]], rs[_RS["by"]], rs[_RS["bz"]])
    alive = rs[_RS["alive"]] > 0.0
    missed = rs[_RS["missed"]] > 0.0
    bg = (rs[_RS["bgx"]], rs[_RS["bgy"]], rs[_RS["bgz"]])
    clamp_v = rs[_RS["clamp"]]
    zero = torch.zeros_like(rad[0])
    rad = _where3(
        missed,
        (rad[0] + beta[0] * bg[0], rad[1] + beta[1] * bg[1],
         rad[2] + beta[2] * bg[2]),
        rad,
    )
    br = (rs[_RS["nex"]], rs[_RS["ney"]], rs[_RS["nez"]])
    for li in range(n_lights):
        b = _N_NEE * li
        lit = (nee[b + 4] > 0.0) & ~(nee[b] > 0.0)
        br = tuple(br[c] + torch.where(lit, nee[b + 1 + c], zero)
                   for c in range(3))
    if has_clamp and bounce > 0:
        br = tuple(torch.minimum(br[c], clamp_v) for c in range(3))
    rad = _where3(
        alive,
        (rad[0] + beta[0] * br[0], rad[1] + beta[1] * br[1],
         rad[2] + beta[2] * br[2]),
        rad,
    )
    return torch.stack([rad[0], rad[1], rad[2], zero])


def resolve_planes(rs, nee, n_lights: int, bounce: int,
                   has_clamp: bool) -> torch.Tensor:
    """The resolve kernel on CUDA tensors, its plain version on CPU ones."""
    if not _build.dispatch(rs):
        return resolve_planes_plain(rs, nee, n_lights, bounce, has_clamp)
    dev = rs.device
    n = rs.shape[1]
    _build.check(rs, "rs", torch.float32, (_N_RS, n), dev)
    _build.check(nee, "nee", torch.float32, (_N_NEE * n_lights, n), dev)
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    err = _build.library().yk_resolve(
        dev.index, _build.ptr(rs), _build.ptr(nee), n, n_lights, int(bounce),
        int(bool(has_clamp)), _build.ptr(out), _build.stream(dev),
    )
    _build.launch_check(err, "resolve")
    LAUNCHES["resolve"] += 1
    return out


def pack_resolve(tb: ShadeTables, radiance, beta, alive, missed, ne, occ,
                 worth, contrib):
    """The resolve kernel's inputs: (rs [16,N] (_RS), nee [5L,N])."""
    n = radiance.shape[0]
    n_lights = tb.n_lights
    clamp_v = 0.0 if tb.indirect_clamp is None else float(tb.indirect_clamp)
    f32 = torch.float32
    rs = torch.stack([
        radiance[:, 0], radiance[:, 1], radiance[:, 2],
        beta[:, 0], beta[:, 1], beta[:, 2],
        alive.to(f32), missed.to(f32), ne[:, 0], ne[:, 1], ne[:, 2],
        tb.bg[0].expand(n), tb.bg[1].expand(n), tb.bg[2].expand(n),
        torch.full((n,), clamp_v, dtype=f32, device=radiance.device),
        torch.zeros(n, dtype=f32, device=radiance.device),
    ])
    occ_f = occ.to(f32).reshape(n_lights, n)
    worth_f = worth.to(f32).reshape(n_lights, n)
    c = contrib.reshape(n_lights, n, 3)
    nee = torch.stack([
        plane for li in range(n_lights)
        for plane in (occ_f[li], c[li, :, 0], c[li, :, 1], c[li, :, 2],
                      worth_f[li])
    ])
    return rs, nee


def resolve_fused(tb: ShadeTables, radiance, beta, alive, missed, ne, occ,
                  worth, contrib, bounce: int):
    """NEE resolve + emission + clamp + miss background + radiance update
    (shade_fused.py:926-1030).  occ/worth [L*N] light-major, contrib
    [L*N,3]; returns the updated radiance [N,3]."""
    rs, nee = pack_resolve(tb, radiance, beta, alive, missed, ne, occ, worth,
                           contrib)
    out = resolve_planes(rs, nee, tb.n_lights, bounce,
                         tb.indirect_clamp is not None)
    return out[:3].t().contiguous()
