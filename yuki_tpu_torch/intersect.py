"""Batched ray/primitive tests: port of ``yuki_tpu/intersect.py``.

  ``ray_triangle``   -> the pbrt watertight test, one triangle a lane
                        (:46-117, yuki/src/shapes/triangle.rs:49-130),
                        staying in float32 where the reference falls back
                        to float64 on an edge function of exactly 0;
  ``slab_test``,
  ``slab_interval``  -> the AABB slab test with NaN-suppressing min/max
                        (:120-142, math/bounds.rs:176-216);
  ``ray_spheres``    -> the closest hit over every sphere (:149-209):
                        spheres are tested brute-force outside the
                        triangle walk (yuki_tpu's divergence from the
                        reference, which puts them in its BVH);
  ``brute_force_triangles`` -> the O(T) closest hit the tests use
                        (:222-245).

In yuki_tpu these run as XLA ops outside any Pallas kernel (the BVH walk,
the sphere queries of traverse.py:660-669 and :843), so here they stay
torch ops.  Each product and sum is its own op (torch does not contract
``a*b - c*d`` into an FMA), every division has a tensor divisor and square
roots are correctly rounded (``vecmath.sqrt``), so the results hold the
bits of eager yuki_tpu on the CPU and on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ops.trace import F32_MAX
from .vecmath import recip
from .vecmath import sqrt as _sqrt


class TriHit(NamedTuple):
    """Closest-hit record of triangle tests.  All [N]."""

    hit: torch.Tensor  # bool
    t: torch.Tensor  # F32_MAX on a miss
    b0: torch.Tensor
    b1: torch.Tensor


def _permute_axis(v, kx, ky, kz):
    """Per-lane component selects (kx, ky, kz in 0..2)."""
    comp = lambda k: torch.where(
        k == 0, v[..., 0], torch.where(k == 1, v[..., 1], v[..., 2]))
    return comp(kx), comp(ky), comp(kz)


def ray_triangle(o, d, t_max, p0, p1, p2) -> TriHit:
    """Watertight ray/triangle test, one triangle a lane: o, d, p* [N,3]
    (or broadcastable), t_max [N].  Returns the hit mask, t and the
    barycentrics b0, b1 (b2 = 1 - b0 - b1)."""
    ad = torch.abs(d)
    # kz = argmax |d|, then cyclic kx, ky (triangle.rs:66-70).
    kz = torch.where((ad[..., 0] > ad[..., 1]) & (ad[..., 0] > ad[..., 2]),
                     0, torch.where(ad[..., 1] > ad[..., 2], 1, 2))
    kx = torch.where(kz < 2, kz + 1, 0)
    ky = torch.where(kx < 2, kx + 1, 0)

    dx, dy, dz = _permute_axis(d, kx, ky, kz)
    p0x, p0y, p0z = _permute_axis(p0 - o, kx, ky, kz)
    p1x, p1y, p1z = _permute_axis(p1 - o, kx, ky, kz)
    p2x, p2y, p2z = _permute_axis(p2 - o, kx, ky, kz)

    # Shear so that d lies on +z (triangle.rs:78-92).
    inv_dz = recip(dz)
    sx = -dx * inv_dz
    sy = -dy * inv_dz
    sz = inv_dz
    p0x = p0x + sx * p0z
    p0y = p0y + sy * p0z
    p1x = p1x + sx * p1z
    p1y = p1y + sy * p1z
    p2x = p2x + sx * p2z
    p2y = p2y + sy * p2z

    e0 = p1x * p2y - p1y * p2x
    e1 = p2x * p0y - p2y * p0x
    e2 = p0x * p1y - p0y * p1x

    any_neg = (e0 < 0.0) | (e1 < 0.0) | (e2 < 0.0)
    any_pos = (e0 > 0.0) | (e1 > 0.0) | (e2 > 0.0)
    miss_sign = any_neg & any_pos

    det = e0 + e1 + e2
    miss_det = det == 0.0
    det_safe = torch.where(miss_det, 1.0, det)

    t_scaled = e0 * (p0z * sz) + e1 * (p1z * sz) + e2 * (p2z * sz)
    # Range test in scaled space (triangle.rs:119-124).
    miss_range = torch.where(
        det < 0.0,
        (t_scaled >= 0.0) | (t_scaled < t_max * det),
        (t_scaled <= 0.0) | (t_scaled > t_max * det),
    )

    inv_det = recip(det_safe)
    t = t_scaled * inv_det
    hit = ~(miss_sign | miss_det | miss_range)
    return TriHit(hit=hit, t=torch.where(hit, t, F32_MAX), b0=e0 * inv_det,
                  b1=e1 * inv_det)


def slab_test(o, inv_d, t_max, lo, hi) -> torch.Tensor:
    """AABB hit predicate (bounds.rs:176-216): tmin <= tmax with tmin
    clamped at 0 and tmax at the ray's t_max.  [N] bool.  fmin/fmax drop
    the NaN of an origin on a slab plane (0 * inf), as Rust's f32 min/max
    do; the reduction over the axes keeps NaN, as jnp.max does."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tmin = torch.amax(torch.fmin(t0, t1), dim=-1)
    tmax = torch.amin(torch.fmax(t0, t1), dim=-1)
    return torch.clamp(tmin, min=0.0) <= torch.minimum(tmax, t_max)


def slab_interval(o, inv_d, t_max, lo, hi):
    """Bounds3::intersections parity: (tmin, tmax, valid)."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tmin = torch.clamp(torch.amax(torch.fmin(t0, t1), dim=-1), min=0.0)
    tmax = torch.minimum(torch.amin(torch.fmax(t0, t1), dim=-1), t_max)
    return tmin, tmax, tmin <= tmax


class SphereHit(NamedTuple):
    hit: torch.Tensor  # [N] bool
    t: torch.Tensor  # [N] f32 (F32_MAX on a miss)
    sphere: torch.Tensor  # [N] i32 winning sphere index, -1 if none


def transform_ray_components(m, o, d):
    """Apply a [4,4] world->object matrix to rays o, d [N,3] with
    component maths (yuki_tpu's op order)."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    ro = torch.stack(
        [
            m[0, 0] * ox + m[0, 1] * oy + m[0, 2] * oz + m[0, 3],
            m[1, 0] * ox + m[1, 1] * oy + m[1, 2] * oz + m[1, 3],
            m[2, 0] * ox + m[2, 1] * oy + m[2, 2] * oz + m[2, 3],
        ],
        dim=-1,
    )
    rd = torch.stack(
        [
            m[0, 0] * dx + m[0, 1] * dy + m[0, 2] * dz,
            m[1, 0] * dx + m[1, 1] * dy + m[1, 2] * dz,
            m[2, 0] * dx + m[2, 1] * dy + m[2, 2] * dz,
        ],
        dim=-1,
    )
    return ro, rd


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def ray_spheres(o, d, t_max, spheres) -> SphereHit:
    """Closest hit over all spheres (object-space stable-q quadratic,
    sphere.rs:37-89); a later sphere wins only when strictly closer."""
    n_spheres = spheres.radius.shape[0]
    best_t = torch.full(o.shape[:-1], F32_MAX, dtype=torch.float32,
                        device=o.device)
    best_i = torch.full(o.shape[:-1], -1, dtype=torch.int32, device=o.device)
    for s in range(n_spheres):
        ro, rd = transform_ray_components(spheres.world_to_obj[s], o, d)
        radius = spheres.radius[s]
        a = _dot(rd, rd)
        b = 2.0 * _dot(rd, ro)
        c = _dot(ro, ro) - radius * radius
        discrim = b * b - 4.0 * a * c
        has_root = discrim >= 0.0
        rt = _sqrt(torch.clamp(discrim, min=0.0))
        q = torch.where(b < 0.0, -0.5 * (b - rt), -0.5 * (b + rt))
        t0 = q / a
        # c/q with q == 0 guarded (graze at the origin).
        t1 = c / torch.where(q == 0.0, 1e-30, q)
        lo_t = torch.minimum(t0, t1)
        hi_t = torch.maximum(t0, t1)
        miss = (lo_t > t_max) | (hi_t <= 0.0)
        t = torch.where(lo_t <= 0.0, hi_t, lo_t)
        miss = miss | (t > t_max) | ~has_root
        closer = ~miss & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_i = torch.where(closer, s, best_i)
    return SphereHit(hit=best_i >= 0, t=best_t, sphere=best_i)


class PrimHit(NamedTuple):
    """Scene-level closest hit: prim >= 0 is a triangle index, sphere >= 0
    a sphere index (exclusive)."""

    hit: torch.Tensor
    t: torch.Tensor
    prim: torch.Tensor
    sphere: torch.Tensor
    b0: torch.Tensor
    b1: torch.Tensor


def brute_force_triangles(o, d, t_max, tris):
    """The O(T) closest hit over every triangle of ``tris`` (p0, p1, p2
    [T,3]), a later triangle winning only when strictly closer; for small
    scenes and traversal tests.  Returns (TriHit, prim [N] i32)."""
    shape = o.shape[:-1]
    f32 = dict(dtype=torch.float32, device=o.device)
    best = TriHit(hit=torch.zeros(shape, dtype=torch.bool, device=o.device),
                  t=torch.full(shape, F32_MAX, **f32),
                  b0=torch.zeros(shape, **f32), b1=torch.zeros(shape, **f32))
    best_prim = torch.full(shape, -1, dtype=torch.int32, device=o.device)
    t_cur = t_max
    for i in range(tris.p0.shape[0]):
        h = ray_triangle(o, d, t_cur, tris.p0[i], tris.p1[i], tris.p2[i])
        closer = h.hit & (h.t < best.t)
        best = TriHit(hit=best.hit | closer,
                      t=torch.where(closer, h.t, best.t),
                      b0=torch.where(closer, h.b0, best.b0),
                      b1=torch.where(closer, h.b1, best.b1))
        best_prim = torch.where(closer, i, best_prim)
        t_cur = torch.where(closer, h.t, t_cur)
    return best, best_prim
