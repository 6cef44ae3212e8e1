"""SoA surface interactions from wavefront hits: port of
``yuki_tpu/surface.py`` (``Surface``, ``make_surface``, ``spawn_ray``,
``spawn_ray_to``, :28-233).

The reference's per-hit ``SurfaceInteraction`` (yuki/src/interaction.rs)
becomes a NamedTuple of [N, ...] tensors built in one masked pass for
triangles and spheres together.  yuki_tpu's one-hot ``rowgather`` of the
shading row is plain indexing here; the sphere branch's divisions by
constants (``phi / phi_max``, ``(theta - theta_min) / (theta_max -
theta_min)``) divide by float32 tensors of the same values, as eager XLA
divides.  ``atan2``, ``acos`` and ``sin`` (the sphere's uv and dp/dv) are
the only transcendentals; XLA and torch may round them an ulp apart.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .intersect import transform_ray_components
from .vecmath import (const, coordinate_system, cross, dot, face_forward,
                      length_sqr, normalize_safe, recip, sqrt)

# The sphere branch's transcendentals, named once so that a test can
# evaluate them one way on both sides.
_atan2, _acos, _sin = torch.atan2, torch.acos, torch.sin


class Surface(NamedTuple):
    """All [N, ...]; lanes with valid False hold safe garbage."""

    valid: torch.Tensor
    p: torch.Tensor  # [N,3] world hit point
    n: torch.Tensor  # geometric normal (handedness- and shading-forwarded)
    ns: torch.Tensor  # shading normal
    ss: torch.Tensor  # shading frame tangent (normalized dpdu')
    uv: torch.Tensor  # [N,2]
    wo: torch.Tensor  # [N,3]
    material: torch.Tensor  # [N] i32
    area_light: torch.Tensor  # [N] i32 (-1 none)

    def frame_t(self) -> torch.Tensor:
        """The BSDF bitangent t = n x s (materials/bsdfs/mod.rs:86-96)."""
        return cross(self.ns, self.ss)


def _mat3(m, a, b, c, col=False):
    """Rows (or, with ``col``, columns) of a [4,4] matrix's upper 3x3
    applied to the components a, b, c, summed left to right."""
    at = (lambda i, j: m[j, i]) if col else (lambda i, j: m[i, j])
    return torch.stack([at(i, 0) * a + at(i, 1) * b + at(i, 2) * c
                        for i in range(3)], dim=-1)


def _sphere_lanes(scene, hit, o, d, p_tri, uv_tri, mat_tri):
    """(p, n, ss, uv, material) of the sphere lanes (sphere.rs:91-125),
    one masked pass a sphere."""
    sph = scene.spheres
    p_s = torch.zeros_like(p_tri)
    n_s = torch.zeros_like(p_tri)
    ss_s = torch.zeros_like(p_tri)
    uv_s = torch.zeros_like(uv_tri)
    mat_s = torch.zeros_like(mat_tri)
    phi_max = 2.0 * math.pi
    theta_min, theta_max = math.pi, 0.0
    phi_max_t = const(phi_max, o)
    theta_range = const(theta_max - theta_min, o)
    for s in range(sph.radius.shape[0]):
        sel = hit.sphere == s
        w2o, o2w = sph.world_to_obj[s], sph.obj_to_world[s]
        radius = sph.radius[s]
        # Object-space hit point, refined (sphere.rs:91-103).
        ro, rd = transform_ray_components(w2o, o, d)
        p_obj = ro + rd * hit.t[..., None]
        p_obj = p_obj * (radius / torch.clamp(sqrt(length_sqr(p_obj)),
                                              min=1e-20))[..., None]
        fix = (p_obj[..., 0] == 0.0) & (p_obj[..., 1] == 0.0)
        px_ = torch.where(fix, 1e-5 * radius, p_obj[..., 0])
        py_, pz_ = p_obj[..., 1], p_obj[..., 2]
        phi = _atan2(py_, px_)
        phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
        u = phi / phi_max_t
        theta = _acos(torch.clamp(pz_ / radius, -1.0, 1.0))
        v = (theta - theta_min) / theta_range
        dpdu_o = torch.stack([-phi_max * py_, phi_max * px_,
                              torch.zeros_like(phi)], dim=-1)
        inv_zr = recip(torch.clamp(sqrt(px_ * px_ + py_ * py_), min=1e-20))
        dpdv_o = torch.stack([pz_ * px_ * inv_zr, pz_ * py_ * inv_zr,
                              -radius * _sin(theta)],
                             dim=-1) * (theta_max - theta_min)
        n_obj = normalize_safe(cross(dpdu_o, dpdv_o))
        n_obj = torch.where(sph.swaps_hand[s], -n_obj, n_obj)
        # To world (interaction.rs Mul<SurfaceInteraction>): points and
        # vectors by o2w, normals by w2o transposed.
        p_w = _mat3(o2w, px_, py_, pz_) + o2w[:3, 3]
        n_w = normalize_safe(_mat3(w2o, n_obj[..., 0], n_obj[..., 1],
                                   n_obj[..., 2], col=True))
        dpdu_w = _mat3(o2w, dpdu_o[..., 0], dpdu_o[..., 1], dpdu_o[..., 2])
        sel3 = sel[..., None]
        p_s = torch.where(sel3, p_w, p_s)
        n_s = torch.where(sel3, n_w, n_s)
        ss_s = torch.where(sel3, normalize_safe(dpdu_w), ss_s)
        uv_s = torch.where(sel3, torch.stack([u, v], dim=-1), uv_s)
        mat_s = torch.where(sel, sph.material[s], mat_s)
    return p_s, n_s, ss_s, uv_s, mat_s


def make_surface(scene, hit, o, d) -> Surface:
    """The shading record of each lane's winning primitive (``scene``:
    SceneData; ``hit``: traverse.SceneHit)."""
    wo = -d
    row = scene.tris.shading_packed[torch.clamp(hit.prim, min=0)
                                    .to(torch.int64)]  # [N,32]
    p0, p1, p2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    n0, n1, n2 = row[..., 9:12], row[..., 12:15], row[..., 15:18]
    uv0, uv1, uv2 = row[..., 18:20], row[..., 20:22], row[..., 22:24]
    has = (row[..., 24] > 0.5)[..., None]  # has_ns
    swaps = (row[..., 25] > 0.5)[..., None]
    mat_tri = row[..., 26].to(torch.int32)
    al_tri = row[..., 27].to(torch.int32)
    b0 = hit.b0[..., None]
    b1 = hit.b1[..., None]
    b2 = 1.0 - b0 - b1

    p_tri = p0 * b0 + p1 * b1 + p2 * b2
    uv_tri = uv0 * b0 + uv1 * b1 + uv2 * b2

    dp02, dp12 = p0 - p2, p1 - p2
    duv02, duv12 = uv0 - uv2, uv1 - uv2
    uv_det = duv02[..., 0] * duv12[..., 1] - duv02[..., 1] * duv12[..., 0]
    degen_uv = uv_det == 0.0
    inv_uv_det = recip(torch.where(degen_uv, 1.0, uv_det))
    dpdu = (dp02 * duv12[..., 1:2] - dp12 * duv02[..., 1:2]) \
        * inv_uv_det[..., None]
    cs_u, _ = coordinate_system(normalize_safe(cross(p2 - p0, p1 - p0)))
    dpdu = torch.where(degen_uv[..., None], cs_u, dpdu)

    # Winding geometric normal with the handedness flip
    # (triangle.rs:186-196).
    n_wind = normalize_safe(cross(dp02, dp12))
    n_wind = torch.where(swaps, -n_wind, n_wind)

    # Shading normal from authored vertex normals (triangle.rs:199-224).
    ns_raw = n0 * b0 + n1 * b1 + n2 * b2
    ns_ok = (length_sqr(ns_raw) > 0.0)[..., None]
    ns_auth = torch.where(ns_ok, normalize_safe(ns_raw), n_wind)
    ss0 = normalize_safe(dpdu)
    ts_raw = cross(ss0, ns_auth)
    ts_ok = (length_sqr(ts_raw) > 0.0)[..., None]
    ts = normalize_safe(ts_raw)
    ss_auth = cross(ts, ns_auth)
    cs_s, _ = coordinate_system(ns_auth)
    ss_auth = torch.where(ts_ok, ss_auth, cs_s)
    # set_shading_geometry: the geometric n is face-forwarded to the
    # shading normal (interaction.rs:126-132).
    ns_tri = torch.where(has, ns_auth, n_wind)
    ss_tri = torch.where(has, ss_auth, ss0)
    n_tri = torch.where(has, face_forward(n_wind, ns_auth), n_wind)

    if scene.spheres.radius.shape[0]:
        p_s, n_s, ss_s, uv_s, mat_s = _sphere_lanes(scene, hit, o, d, p_tri,
                                                    uv_tri, mat_tri)
    else:
        p_s, n_s, ss_s, uv_s, mat_s = p_tri, n_tri, ss_tri, uv_tri, mat_tri

    on_sph = hit.sphere >= 0
    is_sph = on_sph[..., None]
    return Surface(
        valid=hit.hit,
        p=torch.where(is_sph, p_s, p_tri),
        n=torch.where(is_sph, n_s, n_tri),
        ns=torch.where(is_sph, n_s, ns_tri),
        ss=torch.where(is_sph, ss_s, ss_tri),
        uv=torch.where(is_sph, uv_s, uv_tri),
        wo=wo,
        material=torch.where(on_sph, mat_s, mat_tri),
        area_light=torch.where(on_sph, -1, al_tri),
    )


def spawn_ray(si: Surface, d_new: torch.Tensor) -> torch.Tensor:
    """Origin offset 1e-3 along +-geometric n (interaction.rs:26-40)."""
    offset = si.n * 1e-3
    side = (dot(d_new, si.n) > 0.0)[..., None]
    return torch.where(side, si.p + offset, si.p - offset)


def spawn_ray_to(si: Surface, target: torch.Tensor):
    """Shadow ray toward a point: offset origin and the unnormalized
    d = target - o, traced to t_max 0.9999 (interaction.rs:42-59).
    Returns (o, d)."""
    offset = si.n * 1e-3
    side = (dot(target - si.p, si.n) > 0.0)[..., None]
    o = torch.where(side, si.p + offset, si.p - offset)
    return o, target - o
