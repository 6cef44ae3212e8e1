"""The contracts the redesigned raygen kernel's camera sweep
(yuki_tpu_torch/ops/csrc/path_fused.cu, ``camera_sweep`` and its stage)
rests on, held on the CPU against the plain version it is compared with on
the card, and the operation tally behind its bound in ``chip_smoke.py``.

The sweep's arithmetic, rendered here in plain PyTorch: the triangles'
corners less the camera origin, permuted for the ray's shear frame, staged
once a block (a test makes no translation and no select); each sphere's
object-space origin ro and c = |ro|^2 - r^2, staged once; the reciprocal of
det and t, b0, b1 only for a test whose sign, det and range tests pass.
On cameras whose rays span the three shear frames and on Cornell's, it
gives ``raygen_trace_plain``'s t, prim, b0, b1, sphere and hit planes bit
for bit.  Imports no JAX.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from torch_scenes import wide_camera
from yuki_tpu_torch import camera as cam_mod
from yuki_tpu_torch import transforms as tf
from yuki_tpu_torch.camera import Camera
from yuki_tpu_torch.integrators import PathParams
from yuki_tpu_torch.ops import path_fused as tpf
from yuki_tpu_torch.ops.trace import F32_MAX, ray_shear
from yuki_tpu_torch.scene import data as scene_data
from yuki_tpu_torch.scene.cornell import cornell
from yuki_tpu_torch.vecmath import sqrt as exact_sqrt

torch.set_num_threads(2)

RES = (64, 48)
N = 3001
FRAMES = ((0, 1, 2), (1, 2, 0), (2, 0, 1))  # z, x, y dominant: (x, y, z) order


def _origin(tb):
    """The camera origin as the kernel makes it: c2w's translation + 0."""
    c2w = tb.ms[tpf._MS_C2W:tpf._MS_C2W + 16].reshape(4, 4)
    return c2w[0:3, 3] + 0.0


def _stage(tb, o):
    """(copies [3][T, 3, 3]: corner, coordinate in frame order; spheres:
    [S] (ro xyz, c) rows and the [S, 3, 3] rotations), once a wave."""
    corners = tb.tri[:tb.n_tris, :9].reshape(-1, 3, 3) - o
    copies = [corners[:, :, list(p)] for p in FRAMES]
    m = tb.sp[:tb.n_spheres]
    ro = [m[:, 4 * r] * o[0] + m[:, 4 * r + 1] * o[1] + m[:, 4 * r + 2] * o[2]
          + m[:, 4 * r + 3] for r in range(3)]
    c = ro[0] * ro[0] + ro[1] * ro[1] + ro[2] * ro[2] - m[:, 32] * m[:, 32]
    rot = m[:, [0, 1, 2, 4, 5, 6, 8, 9, 10]].reshape(-1, 3, 3)
    return copies, torch.stack(ro + [c], dim=1), rot


def _tri_test(q, sx, sy, inv_dz, t):
    """One staged triangle [N, 3, 3] in each ray's frame against the
    running t: (passed, t_scaled, det, e0, e1), the operations of the
    kernel's test up to its range test."""
    p0tz, p1tz, p2tz = q[:, 0, 2], q[:, 1, 2], q[:, 2, 2]
    p0tx = q[:, 0, 0] + sx * p0tz
    p0ty = q[:, 0, 1] + sy * p0tz
    p1tx = q[:, 1, 0] + sx * p1tz
    p1ty = q[:, 1, 1] + sy * p1tz
    p2tx = q[:, 2, 0] + sx * p2tz
    p2ty = q[:, 2, 1] + sy * p2tz
    e0 = p1tx * p2ty - p1ty * p2tx
    e1 = p2tx * p0ty - p2ty * p0tx
    e2 = p0tx * p1ty - p0ty * p1tx
    miss_sign = ((e0 < 0) | (e1 < 0) | (e2 < 0)) & (
        (e0 > 0) | (e1 > 0) | (e2 > 0))
    det = e0 + e1 + e2
    t_scaled = (e0 * p0tz + e1 * p1tz + e2 * p2tz) * inv_dz
    neg = det < 0.0
    bound = t * det
    miss_range = (neg & ((t_scaled >= 0.0) | (t_scaled < bound))) | (
        ~neg & ((t_scaled <= 0.0) | (t_scaled > bound)))
    return ~(miss_sign | (det == 0.0) | miss_range), t_scaled, det, e0, e1


def _sphere_test(row, rot, d, sqrt):
    """One staged sphere against rays d: (t, hit), sphere_root's
    operations; only the taken branch of q is computed."""
    ro = row[0:3]
    rd = [rot[r, 0] * d[0] + rot[r, 1] * d[1] + rot[r, 2] * d[2]
          for r in range(3)]
    a = rd[0] * rd[0] + rd[1] * rd[1] + rd[2] * rd[2]
    b = 2.0 * (rd[0] * ro[0] + rd[1] * ro[1] + rd[2] * ro[2])
    c = row[3]
    discrim = b * b - 4.0 * a * c
    rt = sqrt(torch.clamp(discrim, min=0.0))
    q = -0.5 * (b + torch.where(b < 0.0, -rt, rt))
    t0 = q / a
    t1 = c / torch.where(q == 0.0, 1e-30, q)
    lo_t = torch.minimum(t0, t1)
    hi_t = torch.maximum(t0, t1)
    t = torch.where(lo_t <= 0.0, hi_t, lo_t)
    miss = (lo_t > F32_MAX) | (hi_t <= 0.0) | (t > F32_MAX) | ~(discrim >= 0.0)
    return t, ~miss


def camera_sweep(tb, d, sqrt=exact_sqrt):
    """The kernel's camera sweep over rays d (3 [N] planes): (t, prim, b0,
    b1, sph, hitf) as raygen_trace_plain's planes."""
    copies, sp_rows, rot = _stage(tb, _origin(tb))
    x_max, y_max, sx, sy, inv_dz = ray_shear(*d)
    frame = torch.where(x_max, 1, torch.where(y_max, 2, 0))
    stacked = torch.stack(copies, dim=1)  # [T, 3 frames, 3, 3]
    t = torch.full_like(d[0], F32_MAX)
    prim = torch.full_like(d[0], -1.0)
    b0, b1 = torch.zeros_like(t), torch.zeros_like(t)
    for i in range(tb.n_tris):
        passed, t_scaled, det, e0, e1 = _tri_test(stacked[i][frame], sx, sy,
                                                  inv_dz, t)
        at = torch.nonzero(passed).squeeze(1)
        inv_det = torch.reciprocal(det[at])
        ti = t_scaled[at] * inv_det
        closer = ti < t[at]
        win = at[closer]
        t[win] = ti[closer]
        prim[win] = float(i)
        b0[win] = e0[win] * inv_det[closer]
        b1[win] = e1[win] * inv_det[closer]
    hitf = prim >= 0.0
    sph = torch.full_like(t, -1.0)
    best_t = torch.full_like(t, F32_MAX)
    best_i = torch.full_like(t, -1.0)
    for s in range(tb.n_spheres):
        ts, hit = _sphere_test(sp_rows[s], rot[s], d, sqrt)
        take = hit & (ts < best_t)
        best_t = torch.where(take, ts, best_t)
        best_i = torch.where(take, float(s), best_i)
    wins = (best_i >= 0.0) & (best_t < t)
    t = torch.where(wins, best_t, t)
    prim = torch.where(wins, -1.0, prim)
    sph = torch.where(wins, best_i, sph)
    return t, prim, b0, b1, sph, (hitf | wins).to(torch.float32)


def _scene(name):
    if name == "cornell":
        scene, cam, _ = cornell(device="cpu")
    else:
        n_tris, n_spheres = (int(x) for x in name.split("x"))
        scene, cam = wide_camera(scene_data, tf, cam_mod, n_tris, n_spheres,
                                 seed=n_tris + n_spheres, device="cpu")
    return tpf.make_tables(scene, Camera.create(cam, *RES), PathParams(5))


def _pixels(seed):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.integers(0, RES[0], N, dtype=np.int32)),
            torch.as_tensor(rng.integers(0, RES[1], N, dtype=np.int32)))


@pytest.mark.parametrize("name", ["cornell", "1x0", "100x1", "1024x5"])
def test_camera_sweep_matches_raygen_plain(name):
    """Cornell's camera and a camera whose rays span the three shear
    frames, with 1, 100 and 1024 triangles and 0, 1 and 5 spheres: the
    sweep's planes equal raygen_trace_plain's bit for bit, with hits on
    triangles and spheres."""
    tb = _scene(name)
    px, py = _pixels(len(name))
    st, _ = tpf.raygen_trace_plain(px, py, 3, 11, tb)
    S = tpf._ST
    d = [st[S[k]] for k in ("dx", "dy", "dz")]
    got = camera_sweep(tb, d)
    for k, g in zip(("t", "prim", "b0", "b1", "sph", "hitf"), got):
        assert torch.equal(g.view(torch.int32), st[S[k]].view(torch.int32)), k
    x_max, y_max = ray_shear(*d)[:2]
    frames = {int(x_max.sum()), int(y_max.sum()), int((~x_max & ~y_max).sum())}
    assert name == "cornell" or min(frames) > N // 5
    assert int((st[S["prim"]] >= 0).sum()) > 0
    if tb.n_spheres:
        assert int((st[S["sph"]] >= 0).sum()) > 0


class _Tally(TorchFunctionMode):
    """Counts the floating-point adds, subtracts, multiplies, divides,
    reciprocals, square roots, min/max and clamps a function makes, one
    for each element of each result (the counted code runs on one ray,
    one triangle and one sphere)."""

    OPS = {"add", "sub", "mul", "div", "__radd__", "__rsub__", "__rmul__",
           "__rdiv__", "__rtruediv__", "reciprocal", "sqrt", "minimum",
           "maximum", "clamp"}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (getattr(func, "__name__", "") in self.OPS
                and isinstance(out, torch.Tensor) and out.is_floating_point()):
            self.n += out.numel()
        return out


def _smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_tally", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_raygen_bound_tally():
    """chip_smoke.py's operations behind raygen's bound, counted on the
    rendering above for one ray: a triangle test up to its range test, the
    winner's reciprocal, t, b0 and b1, a sphere test, the camera (the plain
    version adds the origin's + 0 to each ray, which the kernel makes once
    a wave) and the once-a-wave stage; and raygen_ops sums them."""
    sm = _smoke()
    tb = _scene("1x1")
    d = [torch.tensor([v]) for v in (0.5, 0.6, 0.62)]
    x_max, y_max, sx, sy, inv_dz = ray_shear(*d)
    q = _stage(tb, _origin(tb))[0][0][:1]
    with _Tally() as tally:
        passed, t_scaled, det, e0, e1 = _tri_test(q, sx, sy, inv_dz,
                                                  torch.tensor([F32_MAX]))
    assert tally.n == sm.OPS_CAM_TEST
    with _Tally() as tally:
        inv_det = torch.reciprocal(det)
        _ = (t_scaled * inv_det, e0 * inv_det, e1 * inv_det)
    assert tally.n == sm.OPS_CAM_HIT
    _, sp_rows, rot = _stage(tb, _origin(tb))
    with _Tally() as tally:
        _sphere_test(sp_rows[0], rot[0], d, torch.sqrt)
    assert tally.n == sm.OPS_CAM_SPHERE
    with _Tally() as tally:
        _stage(tb, _origin(tb))
    # The origin's three + 0 and, per triangle and sphere, the stage.
    assert tally.n == 3 + sm.OPS_CAM_WAVE_TRI + sm.OPS_CAM_WAVE_SPHERE
    empty = dataclasses.replace(tb, n_tris=0, n_spheres=0)
    px, py = torch.tensor([3], dtype=torch.int32), torch.tensor(
        [4], dtype=torch.int32)
    spl = torch.tensor([[0.25], [0.75]])
    with _Tally() as tally:
        tpf.raygen_trace_plain(px, py, 0, 1, empty, spl)
    assert tally.n == sm.OPS_CAMERA + 3
    assert sm.raygen_ops(10, 36, 1, 7) == (
        10 * (54 + 36 * 30 + 38) + 7 * 4 + 36 * 9 + 25)
