"""Ray-triangle tests and the dense scenes' trace sweeps: port of
``yuki_tpu/ops/trace.py``.

``watertight`` is the pbrt watertight test (shapes/triangle.rs:49-130) on
[N] ray tensors against one triangle, with ``yuki_tpu``'s op order kept
(``ops/trace.py:120-173``): every product and sum is a separate f32 op,
so it gives the same bits as the JAX form and as the CUDA kernel, which
is built with ``-fmad=false`` for the same reason — contracting
``a*b - c*d`` into an FMA changes the edge functions.

``ray_shear``, ``watertight_scaled`` and ``scaled_min8`` are the
divide-free form the slot-stream walks use (``ops/trace.py:41-117``): the
per-ray shear is hoisted out of the triangle loop, a hit is carried as a
scaled (ts, det) with det > 0 and t = ts / det, and hits are compared by
cross-multiplication.

Kernels (a CUDA tensor launches the hand-written kernel in
``csrc/trace_dense.cu`` or raises; a CPU tensor runs the plain PyTorch
version beside it; each launch adds one to ``LAUNCHES``):

  dense_trace       replaces ``_dense_kernel`` (trace.py:176): closest hit
                    of every ray against every triangle; plain:
                    ``dense_trace_plain``
  dense_trace_skip  replaces ``_dense_skip_kernel`` (:249): the same sweep
                    ignoring the triangles of each lane's skip light, for
                    combined closest + shadow waves; plain:
                    ``dense_trace_skip_plain``
  any_trace         replaces ``_any_kernel`` (:221): occlusion, skipping
                    each lane's light id; plain: ``any_trace_plain``
"""

from __future__ import annotations

import torch

from . import _build

# The largest float32 (yuki_tpu writes 3.4028235e38, which rounds to it).
F32_MAX = 3.4028234663852886e38

LAUNCHES = {"dense_closest": 0, "dense_closest_skip": 0, "dense_any": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pack_triangles(p0: torch.Tensor, p1: torch.Tensor,
                   p2: torch.Tensor) -> torch.Tensor:
    """Build the [T,12] packed layout from [T,3] corner tensors."""
    t = p0.shape[0]
    return torch.cat(
        [p0, p1, p2, torch.zeros((t, 3), dtype=p0.dtype, device=p0.device)],
        dim=1,
    ).contiguous()


def _permute(x_max, y_max, vx, vy, vz):
    """(kx, ky, kz): the cyclic axis order starting after kz = argmax |d|."""
    px = torch.where(x_max, vy, torch.where(y_max, vz, vx))
    py = torch.where(x_max, vz, torch.where(y_max, vx, vy))
    pz = torch.where(x_max, vx, torch.where(y_max, vy, vz))
    return px, py, pz


def ray_shear(dx, dy, dz):
    """The per-ray part of the watertight test (``_ray_shear``): returns
    (x_max, y_max, sx, sy, inv_dz)."""
    adx, ady, adz = torch.abs(dx), torch.abs(dy), torch.abs(dz)
    x_max = (adx > ady) & (adx > adz)
    y_max = (~x_max) & (ady > adz)
    ddx, ddy, ddz = _permute(x_max, y_max, dx, dy, dz)
    inv_dz = torch.reciprocal(ddz)
    return x_max, y_max, -ddx * inv_dz, -ddy * inv_dz, inv_dz


def _edges(pre, ox, oy, oz, cols):
    """The sheared edge functions of one triangle: (e0, e1, e2, miss_sign,
    t_scaled), t_scaled = (e0 p0z + e1 p1z + e2 p2z) / dz."""
    x_max, y_max, sx, sy, inv_dz = pre
    p0x, p0y, p0z, p1x, p1y, p1z, p2x, p2y, p2z = cols
    p0tx, p0ty, p0tz = _permute(x_max, y_max, p0x - ox, p0y - oy, p0z - oz)
    p1tx, p1ty, p1tz = _permute(x_max, y_max, p1x - ox, p1y - oy, p1z - oz)
    p2tx, p2ty, p2tz = _permute(x_max, y_max, p2x - ox, p2y - oy, p2z - oz)
    p0tx = p0tx + sx * p0tz
    p0ty = p0ty + sy * p0tz
    p1tx = p1tx + sx * p1tz
    p1ty = p1ty + sy * p1tz
    p2tx = p2tx + sx * p2tz
    p2ty = p2ty + sy * p2tz
    e0 = p1tx * p2ty - p1ty * p2tx
    e1 = p2tx * p0ty - p2ty * p0tx
    e2 = p0tx * p1ty - p0ty * p1tx
    miss_sign = ((e0 < 0) | (e1 < 0) | (e2 < 0)) & (
        (e0 > 0) | (e1 > 0) | (e2 > 0)
    )
    return e0, e1, e2, miss_sign, (e0 * p0tz + e1 * p1tz + e2 * p2tz) * inv_dz


def watertight(ox, oy, oz, dx, dy, dz, t_cur, cols, pre=None):
    """Watertight test of one triangle (``cols``: its nine corner
    coordinates) against [N] rays.  Returns (hit, t, b0, b1) with
    t = F32_MAX on a miss.  ``pre``: the rays' ``ray_shear``, computed
    here when None."""
    if pre is None:
        pre = ray_shear(dx, dy, dz)
    e0, e1, e2, miss_sign, t_scaled = _edges(pre, ox, oy, oz, cols)
    det = e0 + e1 + e2
    miss_det = det == 0.0
    det_safe = torch.where(miss_det, torch.ones_like(det), det)
    neg = det < 0.0
    bound = t_cur * det
    miss_range = (neg & ((t_scaled >= 0.0) | (t_scaled < bound))) | (
        ~neg & ((t_scaled <= 0.0) | (t_scaled > bound))
    )
    inv_det = torch.reciprocal(det_safe)
    hit = ~(miss_sign | miss_det | miss_range)
    t = torch.where(hit, t_scaled * inv_det, F32_MAX)
    return hit, t, e0 * inv_det, e1 * inv_det


def watertight_scaled(pre, ox, oy, oz, cols):
    """Divide-free watertight test (``_watertight_scaled``) against the
    shear ``pre`` of ``ray_shear``.  Returns (ok, ts, det) with det > 0:
    ``ok`` covers the sign test, det != 0 and ts > 0; the caller applies
    the upper bound by cross-multiplication."""
    e0, e1, e2, miss_sign, ts = _edges(pre, ox, oy, oz, cols)
    det = e0 + e1 + e2
    neg = det < 0.0
    ts = torch.where(neg, -ts, ts)
    det = torch.where(neg, -det, det)
    return ~miss_sign & (det != 0.0) & (ts > 0.0), ts, det


def scaled_min8(ts, det, prim):
    """Reduce [8, ...] scaled-hit carries to the closest (``_scaled_min8``):
    a halving tournament of cross-multiplied compares, the lower prim id
    on an exact scaled tie.  Returns (ts, det, prim) over [...]."""
    while ts.shape[0] > 1:
        h = ts.shape[0] // 2
        ts_a, ts_b = ts[:h], ts[h:]
        det_a, det_b = det[:h], det[h:]
        pr_a, pr_b = prim[:h], prim[h:]
        lhs = ts_b * det_a
        rhs = ts_a * det_b
        take_b = (lhs < rhs) | ((lhs == rhs) & (pr_b < pr_a))
        ts = torch.where(take_b, ts_b, ts_a)
        det = torch.where(take_b, det_b, det_a)
        prim = torch.where(take_b, pr_b, pr_a)
    return ts[0], det[0], prim[0]


# --------------------------------------------------------------------
# Dense sweeps (kernels 4, 5 and 6) and their plain versions
# --------------------------------------------------------------------


def _ray_planes(o, d):
    return (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])


def _sweep_plain(tris_packed, o, d, t_max, tri_light, skip_light, stats):
    ox, oy, oz, dx, dy, dz = _ray_planes(o, d)
    pre = ray_shear(dx, dy, dz)
    t = t_max.clone()
    prim = torch.full_like(t_max, -1, dtype=torch.int32)
    b0, b1 = torch.zeros_like(t_max), torch.zeros_like(t_max)
    live = t_max > 0.0
    passes = takes = 0
    for i, row in enumerate(tris_packed[:, :9].unbind(0)):
        hit, ti, bi0, bi1 = watertight(ox, oy, oz, dx, dy, dz, t,
                                       row.unbind(0), pre)
        closer = hit & (ti < t)
        if skip_light is not None:
            closer = closer & (tri_light[i] != skip_light)
        if stats is not None:
            passes = passes + (hit & live).sum()
            takes = takes + closer.sum()
        t = torch.where(closer, ti, t)
        prim = torch.where(closer, i, prim)
        b0 = torch.where(closer, bi0, b0)
        b1 = torch.where(closer, bi1, b1)
    if stats is not None:
        for key, value in (("tests", live.sum() * tris_packed.shape[0]),
                           ("passes", passes), ("takes", takes)):
            stats[key] = stats.get(key, 0) + int(value)
    return t, prim, b0, b1


def dense_trace_plain(tris_packed, o, d, t_max, stats=None):
    """Plain version of the closest sweep (``_dense_kernel``): triangles in
    ascending order, each taken when it hits within the running t and
    ti < t, so the lowest index wins an exact tie.  Returns (t, prim i32,
    b0, b1), t = t_max and prim -1 on a miss.  ``stats`` receives "tests"
    (lanes with t_max > 0 against every triangle), "passes" (those tests
    that pass the sign, det and range tests) and "takes" (the hits
    taken)."""
    return _sweep_plain(tris_packed, o, d, t_max, None, None, stats)


def dense_trace_skip_plain(tris_packed, tri_light, o, d, t_max, skip_light,
                           stats=None):
    """Plain version of the skip sweep (``_dense_skip_kernel``): as
    dense_trace_plain, but a triangle whose area-light id (``tri_light``
    [T] i32) equals the lane's ``skip_light`` [N] i32 is never taken; -2
    skips nothing."""
    return _sweep_plain(tris_packed, o, d, t_max, tri_light, skip_light,
                        stats)


def any_trace_plain(tris_packed, tri_light, o, d, t_max, skip_light,
                    stats=None):
    """Plain version of the occlusion sweep (``_any_kernel``): [N] bool, a
    hit within (0, t_max] by a triangle whose light id differs from the
    lane's ``skip_light``.  ``stats`` receives "tests": per lane with
    t_max > 0, the triangles up to and including its first occluder (all
    if none), less those of its skip light, which the kernel passes over
    untested."""
    ox, oy, oz, dx, dy, dz = _ray_planes(o, d)
    pre = ray_shear(dx, dy, dz)
    occ = torch.zeros_like(t_max, dtype=torch.bool)
    n_tris = tris_packed.shape[0]
    first = torch.full_like(t_max, n_tris, dtype=torch.int64)
    skipped = torch.zeros_like(first)
    for i, (row, light) in enumerate(zip(tris_packed[:, :9].unbind(0),
                                         tri_light.unbind(0))):
        hit = watertight(ox, oy, oz, dx, dy, dz, t_max, row.unbind(0), pre)[0]
        mine = light == skip_light
        skipped = skipped + (mine & ~occ).to(torch.int64)
        blocked = hit & ~mine
        first = torch.where(blocked & ~occ, i + 1, first)
        occ = occ | blocked
    if stats is not None:
        stats["tests"] = stats.get("tests", 0) + int(
            (first - skipped)[t_max > 0.0].sum())
    return occ


def _check_dense(tris_packed, o, d, t_max, dev):
    n = o.shape[0]
    f32 = torch.float32
    _build.check(tris_packed, "tris_packed", f32, (tris_packed.shape[0], 12),
                 dev)
    _build.check(o, "o", f32, (n, 3), dev)
    _build.check(d, "d", f32, (n, 3), dev)
    _build.check(t_max, "t_max", f32, (n,), dev)
    _build.check_aligned(tris_packed, "tris_packed")
    return n


def _closest_sweep(tris_packed, tri_light, o, d, t_max, skip_light):
    dev = o.device
    n = _check_dense(tris_packed, o, d, t_max, dev)
    light = skip = None
    if skip_light is not None:
        _build.check(tri_light, "tri_light", torch.int32,
                     (tris_packed.shape[0],), dev)
        _build.check(skip_light, "skip_light", torch.int32, (n,), dev)
        light, skip = _build.ptr(tri_light), _build.ptr(skip_light)
    t = torch.empty_like(t_max)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    b0, b1 = torch.empty_like(t_max), torch.empty_like(t_max)
    if n:
        name = "dense_closest" if skip is None else "dense_closest_skip"
        err = _build.library().yk_dense_closest(
            dev.index, _build.ptr(tris_packed), light,
            tris_packed.shape[0], _build.ptr(o), _build.ptr(d),
            _build.ptr(t_max), skip, n, _build.ptr(t), _build.ptr(prim),
            _build.ptr(b0), _build.ptr(b1), _build.stream(dev))
        _build.launch_check(err, name)
        _build.bump(LAUNCHES, name)
    return t, prim, b0, b1


def dense_trace(tris_packed, o, d, t_max):
    """Closest hit of rays o, d [N,3], t_max [N] against every triangle of
    ``tris_packed`` [T,12] (``pack_triangles``).  Returns (t, prim i32, b0,
    b1) [N]."""
    if not _build.dispatch(o):
        return dense_trace_plain(tris_packed, o, d, t_max)
    return _closest_sweep(tris_packed, None, o, d, t_max, None)


def dense_trace_skip(tris_packed, tri_light, o, d, t_max, skip_light):
    """dense_trace ignoring, for each lane, the triangles whose area-light
    id (``tri_light`` [T] i32) equals its ``skip_light`` [N] i32."""
    if not _build.dispatch(o):
        return dense_trace_skip_plain(tris_packed, tri_light, o, d, t_max,
                                      skip_light)
    return _closest_sweep(tris_packed, tri_light, o, d, t_max, skip_light)


def any_trace(tris_packed, tri_light, o, d, t_max, skip_light):
    """Occlusion [N] bool of rays o, d, t_max against every triangle; a
    triangle whose area-light id (``tri_light`` [T] i32) equals the lane's
    ``skip_light`` [N] i32 is ignored."""
    if not _build.dispatch(o):
        return any_trace_plain(tris_packed, tri_light, o, d, t_max, skip_light)
    dev = o.device
    n = _check_dense(tris_packed, o, d, t_max, dev)
    _build.check(tri_light, "tri_light", torch.int32, (tris_packed.shape[0],),
                 dev)
    _build.check(skip_light, "skip_light", torch.int32, (n,), dev)
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        err = _build.library().yk_dense_any(
            dev.index, _build.ptr(tris_packed), _build.ptr(tri_light),
            tris_packed.shape[0], _build.ptr(o), _build.ptr(d),
            _build.ptr(t_max), _build.ptr(skip_light), n, _build.ptr(occ),
            _build.stream(dev))
        _build.launch_check(err, "dense_any")
        _build.bump(LAUNCHES, "dense_any")
    return occ
