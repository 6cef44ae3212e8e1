"""The dense wave's kernels (raygen_trace and bounce, or the one-kernel
wave) against their bound, in %: the larger of the operations the
traced frames' rays need over the float32 peak and their lanes' bytes
over the memory's bandwidth, divided by the kernels' device time."""

from ..stats import LANE_BYTES, bound_seconds, wave_ops
from ..trace import own_kernel_matcher

KERNELS = ("raygen_trace_kernel", "bounce_kernel", "wave_kernel")


def read(r):
    t, win, sc = r["trace"], r["win"], r["scene"]
    if t is None or not win.traced_launches:
        return None
    secs = t.kernel_seconds(own_kernel_matcher(KERNELS))
    if secs <= 0:
        return None
    ops = wave_ops(win.traced_lanes, win.traced_rays, win.traced_launches,
                   sc.n_tris, sc.n_spheres)
    return 100.0 * bound_seconds(ops, win.traced_lanes * LANE_BYTES) / secs
