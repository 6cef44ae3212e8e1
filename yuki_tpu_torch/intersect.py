"""Ray-sphere queries: port of ``yuki_tpu/intersect.py``'s
``transform_ray_components`` and ``ray_spheres`` (:149-209) as torch ops.

Spheres are tested brute-force outside the triangle walk (yuki_tpu's
divergence from the reference, which puts them in its BVH).  In yuki_tpu
this runs as XLA ops outside any Pallas kernel (traverse.py:660-669,
:843), so here it stays torch glue.  Every division has a tensor divisor
and square roots are correctly rounded (``vecmath.sqrt``), so the results
hold the same bits on the CPU and the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ops.trace import F32_MAX
from .vecmath import sqrt as _sqrt


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
