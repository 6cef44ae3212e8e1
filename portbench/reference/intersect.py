"""Scene queries of the reference renderer, by brute force.

Every ray is tested against every triangle (pbrt's watertight test) and
every sphere (the object-space quadratic), in blocks of rays by blocks of
triangles so that the tests fit in memory.  There is no acceleration
structure: a closest hit is the nearest passing test, the earlier
triangle on an exact tie; an occlusion is any passing test whose
triangle does not belong to the ray's skipped area light, or any sphere.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .rmath import sqrt

# Elements of one [rays, triangles] block of tests, on the card and on
# the host.
BLOCK_CUDA = 1 << 24
BLOCK_CPU = 1 << 20


class Hit(NamedTuple):
    hit: torch.Tensor
    t: torch.Tensor
    prim: torch.Tensor  # int64 triangle, -1 none
    sphere: torch.Tensor  # int64 sphere, -1 none
    b0: torch.Tensor
    b1: torch.Tensor


def big(dtype) -> float:
    return float(torch.finfo(dtype).max)


def _axis(v, k):
    return torch.where(k == 0, v[..., 0], torch.where(k == 1, v[..., 1],
                                                      v[..., 2]))


def watertight(o, d, t_max, p0, p1, p2):
    """Rays o, d [R,1,3], t_max [R,1] against triangles p* [1,T,3]:
    (hit, t, b0, b1), each [R,T].  pbrt's watertight test (shapes/
    triangle.rs:49-130) in the operation order of yuki's dense sweep:
    t_scaled = (e0 p0z + e1 p1z + e2 p2z) / dz, reciprocals by
    ``torch.reciprocal``."""
    ad = torch.abs(d)
    kz = torch.where((ad[..., 0] > ad[..., 1]) & (ad[..., 0] > ad[..., 2]), 0,
                     torch.where(ad[..., 1] > ad[..., 2], 1, 2))
    kx = torch.where(kz < 2, kz + 1, 0)
    ky = torch.where(kx < 2, kx + 1, 0)
    dx, dy, dz = _axis(d, kx), _axis(d, ky), _axis(d, kz)
    a, b, c = p0 - o, p1 - o, p2 - o
    p0x, p0y, p0z = _axis(a, kx), _axis(a, ky), _axis(a, kz)
    p1x, p1y, p1z = _axis(b, kx), _axis(b, ky), _axis(b, kz)
    p2x, p2y, p2z = _axis(c, kx), _axis(c, ky), _axis(c, kz)
    inv_dz = torch.reciprocal(dz)
    sx, sy = -dx * inv_dz, -dy * inv_dz
    p0x, p0y = p0x + sx * p0z, p0y + sy * p0z
    p1x, p1y = p1x + sx * p1z, p1y + sy * p1z
    p2x, p2y = p2x + sx * p2z, p2y + sy * p2z
    e0 = p1x * p2y - p1y * p2x
    e1 = p2x * p0y - p2y * p0x
    e2 = p0x * p1y - p0y * p1x
    miss = (((e0 < 0.0) | (e1 < 0.0) | (e2 < 0.0))
            & ((e0 > 0.0) | (e1 > 0.0) | (e2 > 0.0)))
    det = e0 + e1 + e2
    miss = miss | (det == 0.0)
    ts = (e0 * p0z + e1 * p1z + e2 * p2z) * inv_dz
    bound = t_max * det
    miss = miss | torch.where(det < 0.0, (ts >= 0.0) | (ts < bound),
                              (ts <= 0.0) | (ts > bound))
    inv_det = torch.reciprocal(torch.where(det == 0.0, 1.0, det))
    return ~miss, ts * inv_det, e0 * inv_det, e1 * inv_det


def _blocks(n_rays: int, n_tris: int, cuda: bool):
    tc = min(n_tris, 1 << 16)
    rc = max(1, min(n_rays, (BLOCK_CUDA if cuda else BLOCK_CPU) // max(tc, 1)))
    for r0 in range(0, n_rays, rc):
        for t0 in range(0, n_tris, tc):
            yield slice(r0, min(r0 + rc, n_rays)), slice(t0, min(t0 + tc, n_tris))


def spheres(sc, o, d, t_max):
    """(hit, t, index) of the nearest sphere; a later sphere only when
    strictly nearer."""
    sph = sc.sph
    inf = big(o.dtype)
    best_t = torch.full(o.shape[:-1], inf, dtype=o.dtype, device=o.device)
    best_i = torch.full(o.shape[:-1], -1, dtype=torch.int64, device=o.device)
    for s in range(sph.radius.shape[0]):
        m = sph.w2o[s]
        ro = torch.stack([m[i, 0] * o[..., 0] + m[i, 1] * o[..., 1]
                          + m[i, 2] * o[..., 2] + m[i, 3] for i in range(3)], -1)
        rd = torch.stack([m[i, 0] * d[..., 0] + m[i, 1] * d[..., 1]
                          + m[i, 2] * d[..., 2] for i in range(3)], -1)
        r = sph.radius[s]
        dt = lambda u, v: u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1] + u[..., 2] * v[..., 2]
        a = dt(rd, rd)
        b = 2.0 * dt(rd, ro)
        c = dt(ro, ro) - r * r
        disc = b * b - 4.0 * a * c
        rt = sqrt(torch.clamp(disc, min=0.0))
        q = torch.where(b < 0.0, -0.5 * (b - rt), -0.5 * (b + rt))
        t0 = q / a
        t1 = c / torch.where(q == 0.0, 1e-30, q)
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        t = torch.where(lo <= 0.0, hi, lo)
        miss = (lo > t_max) | (hi <= 0.0) | (t > t_max) | (disc < 0.0)
        closer = ~miss & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_i = torch.where(closer, s, best_i)
    return best_i >= 0, best_t, best_i


def closest(sc, o, d, t_max) -> Hit:
    """Nearest hit of rays o, d [N,3] within t_max [N]."""
    n, dev, dt = o.shape[0], o.device, o.dtype
    tri = sc.tri
    inf = big(dt)
    best_t = torch.full((n,), inf, dtype=dt, device=dev)
    best_p = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_b0 = torch.zeros((n,), dtype=dt, device=dev)
    best_b1 = torch.zeros((n,), dtype=dt, device=dev)
    for rs, ts in _blocks(n, sc.n_tris, o.is_cuda):
        h, t, b0, b1 = watertight(o[rs, None], d[rs, None], t_max[rs, None],
                                  tri.p0[None, ts], tri.p1[None, ts],
                                  tri.p2[None, ts])
        t = torch.where(h, t, inf)
        tmin, arg = torch.min(t, dim=1)  # the first of equal minima
        take = tmin < best_t[rs]
        ar = arg[:, None]
        best_t[rs] = torch.where(take, tmin, best_t[rs])
        best_p[rs] = torch.where(take, arg + ts.start, best_p[rs])
        best_b0[rs] = torch.where(take, b0.gather(1, ar)[:, 0], best_b0[rs])
        best_b1[rs] = torch.where(take, b1.gather(1, ar)[:, 0], best_b1[rs])
    s_hit, s_t, s_i = spheres(sc, o, d, t_max)
    wins = s_hit & (s_t < best_t)
    return Hit(hit=(best_p >= 0) | wins, t=torch.where(wins, s_t, best_t),
               prim=torch.where(wins, -1, best_p),
               sphere=torch.where(wins, s_i, -1), b0=best_b0, b1=best_b1)


def occluded(sc, o, d, t_max, skip) -> torch.Tensor:
    """Whether anything lies on each segment: triangles of the ray's
    ``skip`` area light [N] (int64; -2 none) are passed over."""
    n = o.shape[0]
    tri = sc.tri
    occ = torch.zeros((n,), dtype=torch.bool, device=o.device)
    live = t_max > 0.0
    for rs, ts in _blocks(n, sc.n_tris, o.is_cuda):
        h = watertight(o[rs, None], d[rs, None], t_max[rs, None],
                       tri.p0[None, ts], tri.p1[None, ts], tri.p2[None, ts])[0]
        h = h & (tri.light[None, ts] != skip[rs, None])
        occ[rs] |= h.any(dim=1) & live[rs]
    return occ | spheres(sc, o, d, t_max)[0]
