"""Plain ray-triangle pieces shared by the wave (port of the plain parts of
``yuki_tpu/ops/trace.py``).

``watertight`` is the pbrt watertight test (shapes/triangle.rs:49-130) on
[N] ray tensors against one triangle, with ``yuki_tpu``'s op order kept
(``ops/trace.py:120-173``): every product and sum is a separate f32 op,
so it gives the same bits as the JAX form and as the CUDA kernel, which
is built with ``-fmad=false`` for the same reason — contracting
``a*b - c*d`` into an FMA changes the edge functions.
"""

from __future__ import annotations

import torch

# The largest float32 (yuki_tpu writes 3.4028235e38, which rounds to it).
F32_MAX = 3.4028234663852886e38


def pack_triangles(p0: torch.Tensor, p1: torch.Tensor,
                   p2: torch.Tensor) -> torch.Tensor:
    """Build the [T,12] packed layout from [T,3] corner tensors."""
    t = p0.shape[0]
    return torch.cat(
        [p0, p1, p2, torch.zeros((t, 3), dtype=p0.dtype, device=p0.device)],
        dim=1,
    ).contiguous()


def watertight(ox, oy, oz, dx, dy, dz, t_cur, cols):
    """Watertight test of one triangle (``cols``: its nine corner
    coordinates) against [N] rays.  Returns (hit, t, b0, b1) with
    t = F32_MAX on a miss."""
    p0x, p0y, p0z, p1x, p1y, p1z, p2x, p2y, p2z = cols

    adx, ady, adz = torch.abs(dx), torch.abs(dy), torch.abs(dz)
    # kz = argmax |d| per lane, via selects.
    x_max = (adx > ady) & (adx > adz)
    y_max = (~x_max) & (ady > adz)

    def permute(vx, vy, vz):
        # (kx, ky, kz) = cyclic starting after kz.
        px = torch.where(x_max, vy, torch.where(y_max, vz, vx))
        py = torch.where(x_max, vz, torch.where(y_max, vx, vy))
        pz = torch.where(x_max, vx, torch.where(y_max, vy, vz))
        return px, py, pz

    ddx, ddy, ddz = permute(dx, dy, dz)
    p0tx, p0ty, p0tz = permute(p0x - ox, p0y - oy, p0z - oz)
    p1tx, p1ty, p1tz = permute(p1x - ox, p1y - oy, p1z - oz)
    p2tx, p2ty, p2tz = permute(p2x - ox, p2y - oy, p2z - oz)

    inv_dz = torch.reciprocal(ddz)
    sx = -ddx * inv_dz
    sy = -ddy * inv_dz
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
    det = e0 + e1 + e2
    miss_det = det == 0.0
    det_safe = torch.where(miss_det, torch.ones_like(det), det)

    t_scaled = (e0 * p0tz + e1 * p1tz + e2 * p2tz) * inv_dz
    neg = det < 0.0
    bound = t_cur * det
    miss_range = (neg & ((t_scaled >= 0.0) | (t_scaled < bound))) | (
        ~neg & ((t_scaled <= 0.0) | (t_scaled > bound))
    )
    inv_det = torch.reciprocal(det_safe)
    hit = ~(miss_sign | miss_det | miss_range)
    t = torch.where(hit, t_scaled * inv_det, F32_MAX)
    return hit, t, e0 * inv_det, e1 * inv_det
