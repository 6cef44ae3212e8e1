"""The benchmark's arithmetic: percentiles, rates and the roofline
bound of the dense wave's kernels.

The operation tallies are frozen copies of ``chip_smoke.py``'s (the
watertight test, the sphere test and the camera sweep's per-ray and
per-wave work); the peaks are the published figures of one H100 SXM
(NVIDIA's data sheet): 67 TFLOP/s in float32 outside the tensor cores
and 3.35 TB/s of HBM.
"""

from __future__ import annotations

import math

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

OPS_WATERTIGHT = 43  # 9 translate, 12 shear, 9 edges, 2 det, 6 t_scaled,
# 1 bound, 1 divide, 1 t, 2 barycentrics
OPS_SPHERE = 60  # transform 33, quadratic 21, root, q, two divides
OPS_CAMERA = 54  # jitter 2, raster->camera 19, normalise 9 (twice), c2w 15
OPS_CAM_TEST = 30  # a camera ray's triangle test: 12 shear, 9 edges, 2 det,
# 6 t_scaled, 1 bound (the translation is shared by the wave's rays)
OPS_CAM_SPHERE = 38  # a camera ray's sphere test
OPS_CAM_HIT = 4  # the winning test's reciprocal, t, b0 and b1
OPS_CAM_WAVE_TRI = 9  # a triangle's corners less the origin, once a wave
OPS_CAM_WAVE_SPHERE = 25  # a sphere's ro and c, once a wave
# A lane's bytes through the wave: its pixel in (px, py), its radiance and
# ray count out.
LANE_BYTES = 4 + 4 + 12 + 4


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    order statistics (numpy's default method)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: int, seconds: float, unit: float = 1e6) -> float:
    """count / seconds in units of ``unit`` (1e6: millions a second)."""
    if seconds <= 0.0:
        raise ValueError("rate over no time")
    return count / seconds / unit


def raygen_ops(n: int, n_tris: int, n_spheres: int, hits: int) -> int:
    """Operations of n camera rays of which ``hits`` end on a triangle."""
    return (n * (OPS_CAMERA + n_tris * OPS_CAM_TEST
                 + n_spheres * OPS_CAM_SPHERE) + hits * OPS_CAM_HIT
            + n_tris * OPS_CAM_WAVE_TRI + n_spheres * OPS_CAM_WAVE_SPHERE)


def wave_ops(camera_rays: int, rays: int, launches: int, n_tris: int,
             n_spheres: int) -> int:
    """Operations the dense wave needs: each launch's camera sweep (its
    winners' divides not counted) and each further closest-hit ray's test
    of every triangle and sphere.  Shading and shadow sweeps, which exit
    early, are not counted."""
    cam = (raygen_ops(camera_rays, n_tris, n_spheres, 0)
           + (launches - 1) * raygen_ops(0, n_tris, n_spheres, 0))
    return cam + (rays - camera_rays) * (n_tris * OPS_WATERTIGHT
                                         + n_spheres * OPS_SPHERE)


def bound_seconds(ops: int, nbytes: int) -> float:
    """The least time the card could take: the larger of operations over
    the float32 peak and bytes over the memory's bandwidth."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)
