"""The contracts the redesigned dense closest sweep
(yuki_tpu_torch/ops/csrc/trace_dense.cu, ``dense_closest_kernel``) rests
on, held on the CPU against the plain versions it is compared with on the
card.

The kernel's sweep, rendered here in plain PyTorch: the triangles staged
as copies whose corners are permuted for each shear frame, a ray's test on
its frame's copy from its origin in that frame (9 subtracts, no selects),
the reciprocal of det and ti only for a test whose sign, det and range
tests pass, b0 and b1 only when ti < t takes the hit; triangles in
ascending order with the running t in the range test.  On rays from random
origins in every direction (all three frames), with dead, NaN and finite
t_max, exact ties between duplicated triangles and skip ids, it gives
``dense_trace_plain``'s and ``dense_trace_skip_plain``'s t, prim, b0, b1
bit for bit; the sweep cut before the last triangle that wins a ray does
not.  Imports no JAX.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from yuki_tpu_torch.ops import trace as ttr
from yuki_tpu_torch.ops.trace import F32_MAX, ray_shear

torch.set_num_threads(2)

N = 2000
FRAMES = ((0, 1, 2), (1, 2, 0), (2, 0, 1))  # z, x, y dominant: (x, y, z) order


def soup(n_tris, seed):
    """A soup [T, 12] in [-3, 3]^3 whose every fifth triangle (and light
    id) copies the one before, light ids -1, 0, 1, and N rays: half aimed
    at a triangle's centroid, every sixteenth axis-parallel from a corner;
    t_max F32_MAX, 2.0 on a fifth, 0 on a seventh, -1 and NaN on a few;
    skip ids -2, 0, 1."""
    rng = np.random.default_rng(seed)
    base = (rng.random((n_tris, 1, 3)) - 0.5) * 6
    tri = (base + rng.standard_normal((n_tris, 3, 3)) * 0.4).astype(
        np.float32)
    tri[5::5] = tri[4:-1:5]
    light = rng.choice([-1, -1, 0, 1], n_tris).astype(np.int32)
    light[5::5] = light[4:-1:5]
    packed = np.zeros((n_tris, 12), np.float32)
    packed[:, :9] = tri.reshape(n_tris, 9)
    o = ((rng.random((N, 3)) - 0.5) * 6).astype(np.float32)
    d = rng.standard_normal((N, 3)).astype(np.float32)
    aim = np.arange(N) % 2 == 1
    d[aim] = tri.mean(axis=1)[rng.integers(0, n_tris, aim.sum())] - o[aim]
    par = np.arange(N) % 16 == 0
    d[par] = 0.0
    d[par, rng.integers(0, 3, par.sum())] = rng.choice([-1.0, 1.0], par.sum())
    o[par] = tri[rng.integers(0, n_tris, par.sum()), 0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(N, F32_MAX, np.float32)
    t_max[rng.random(N) < 0.2] = 2.0
    t_max[np.arange(N) % 7 == 3] = 0.0
    t_max[np.arange(N) % 97 == 5] = -1.0
    t_max[np.arange(N) % 101 == 7] = np.nan
    skip = rng.choice([-2, 0, 1], N).astype(np.int32)
    return [torch.as_tensor(x) for x in (packed, light, o, d, t_max, skip)]


def framed_sweep(tris, o, d, t_max, light=None, skip=None, n_sweep=None):
    """dense_closest_kernel's sweep over the first ``n_sweep`` triangles
    (all when None): (t, prim i32, b0, b1)."""
    x_max, y_max, sx, sy, inv_dz = ray_shear(d[:, 0], d[:, 1], d[:, 2])
    frame = torch.where(x_max, 1, torch.where(y_max, 2, 0))
    perm = torch.as_tensor(FRAMES)[frame]  # [N, 3]
    of = torch.gather(o, 1, perm)
    corners = tris[:, :9].reshape(-1, 3, 3)
    copies = torch.stack([corners[:, :, list(p)] for p in FRAMES], dim=1)
    t = t_max.clone()
    prim = torch.full_like(t_max, -1, dtype=torch.int32)
    b0, b1 = torch.zeros_like(t_max), torch.zeros_like(t_max)
    n_sweep = tris.shape[0] if n_sweep is None else n_sweep
    for i in range(n_sweep):
        # copies[i][frame]: each ray's frame's copy, [N, 3 corners, 3]
        passed, t_scaled, det, e0, e1 = _test(copies[i][frame], of, sx, sy,
                                              inv_dz, t)
        at = torch.nonzero(passed).squeeze(1)
        inv_det, ti = _divide(det[at], t_scaled[at])
        closer = ti < t[at]
        if skip is not None:
            closer = closer & (light[i] != skip[at])
        win = at[closer]
        t[win] = ti[closer]
        prim[win] = i
        b0[win], b1[win] = _take(e0[win], e1[win], inv_det[closer])
    return t, prim, b0, b1


def _test(q, of, sx, sy, inv_dz, t):
    """One staged triangle q [N, 3, 3] in each ray's frame from its origin
    ``of`` [N, 3] in that frame, against the running t: (passed, t_scaled,
    det, e0, e1), the operations of the kernel's test up to its range
    test."""
    p0tx, p0ty, p0tz = (q[:, 0, a] - of[:, a] for a in range(3))
    p1tx, p1ty, p1tz = (q[:, 1, a] - of[:, a] for a in range(3))
    p2tx, p2ty, p2tz = (q[:, 2, a] - of[:, a] for a in range(3))
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
        (e0 > 0) | (e1 > 0) | (e2 > 0))
    det = e0 + e1 + e2
    t_scaled = (e0 * p0tz + e1 * p1tz + e2 * p2tz) * inv_dz
    neg = det < 0.0
    bound = t * det
    miss_range = (neg & ((t_scaled >= 0.0) | (t_scaled < bound))) | (
        ~neg & ((t_scaled <= 0.0) | (t_scaled > bound)))
    return ~(miss_sign | (det == 0.0) | miss_range), t_scaled, det, e0, e1


def _divide(det, t_scaled):
    """A passing test's reciprocal of det and its ti."""
    inv_det = torch.reciprocal(det)
    return inv_det, t_scaled * inv_det


def _take(e0, e1, inv_det):
    """A taken hit's b0 and b1."""
    return e0 * inv_det, e1 * inv_det


def _equal(got, ref):
    return all(torch.equal(g.view(torch.int32), r.view(torch.int32))
               for g, r in zip(got, ref))


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("n_tris", [1, 36, 300])
def test_framed_sweep_matches_plain(n_tris, skip):
    """The kernel's sweep equals the plain sweep bit for bit; duplicated
    triangles tie exactly and the lower index wins; the sweep cut before
    the last triangle that wins a ray differs."""
    tris, light, o, d, t_max, sk = soup(n_tris, 11 + n_tris)
    if skip:
        ref = ttr.dense_trace_skip_plain(tris, light, o, d, t_max, sk)
    else:
        ref = ttr.dense_trace_plain(tris, o, d, t_max)
        light = sk = None
    got = framed_sweep(tris, o, d, t_max, light, sk)
    assert _equal(got, ref)
    # Cut before the last triangle that wins a ray.
    early = framed_sweep(tris, o, d, t_max, light, sk, int(ref[1].max()))
    assert not _equal(early, ref)
    prim = got[1]
    assert int((prim >= 0).sum()) > N // 10
    assert int((prim[prim > 0] % 5 == 0).sum()) == 0  # no copy wins its tie
    if n_tris >= 36:
        assert int(((prim % 5 == 4) & (prim >= 0)).sum()) > 0
    x_max, y_max = ray_shear(d[:, 0], d[:, 1], d[:, 2])[:2]
    assert min(int(x_max.sum()), int(y_max.sum()),
               int((~x_max & ~y_max).sum())) > N // 5
    dead = ~(t_max > 0.0)
    assert bool((prim[dead] == -1).all())
    assert bool(torch.isnan(got[0][torch.isnan(t_max)]).all())


class _Tally(TorchFunctionMode):
    """Counts the floating-point adds, subtracts, multiplies, divides and
    reciprocals a function makes, one for each element of each result."""

    OPS = {"add", "sub", "mul", "div", "__radd__", "__rsub__", "__rmul__",
           "__rdiv__", "__rtruediv__", "reciprocal"}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (getattr(func, "__name__", "") in self.OPS
                and isinstance(out, torch.Tensor) and out.is_floating_point()):
            self.n += out.numel()
        return out


def test_dense_bound_tally():
    """chip_smoke.py's operations behind the dense closest sweep's bound,
    counted on the rendering above for one ray and one triangle: the test
    up to its range test, a pass's reciprocal and ti, a take's b0 and b1;
    and dense_ops sums them over dense_trace_plain's tally, whose counts
    are the rendering's."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_dense", path)
    sm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sm)
    q = torch.tensor([[[0.1, 0.2, 2.0], [1.0, 0.1, 2.1], [0.2, 1.0, 2.2]]])
    one = [torch.tensor([x]) for x in (0.3, -0.2, 0.5, 5.0)]
    with _Tally() as tally:
        _, t_scaled, det, e0, e1 = _test(q, torch.zeros((1, 3)), *one)
    assert tally.n == sm.OPS_DENSE_TEST
    with _Tally() as tally:
        inv_det, _ = _divide(det, t_scaled)
    assert tally.n == sm.OPS_DENSE_PASS
    with _Tally() as tally:
        _take(e0, e1, inv_det)
    assert tally.n == sm.OPS_DENSE_TAKE

    tris, light, o, d, t_max, sk = soup(36, 5)
    stats = {}
    ttr.dense_trace_skip_plain(tris, light, o, d, t_max, sk, stats)
    passes = takes = 0
    x_max, y_max, sx, sy, inv_dz = ray_shear(d[:, 0], d[:, 1], d[:, 2])
    perm = torch.as_tensor(FRAMES)[torch.where(x_max, 1, torch.where(
        y_max, 2, 0))]
    of = torch.gather(o, 1, perm)
    corners = tris[:, :9].reshape(-1, 3, 3)
    t = t_max.clone()
    for i in range(36):
        passed, t_scaled, det, _, _ = _test(
            torch.gather(corners[i].expand(N, 3, 3), 2,
                         perm[:, None, :].expand(N, 3, 3)), of, sx, sy,
            inv_dz, t)
        ti = _divide(det, t_scaled)[1]
        closer = passed & (ti < t) & (light[i] != sk)
        passes += int((passed & (t_max > 0.0)).sum())
        takes += int(closer.sum())
        t = torch.where(closer, ti, t)
    assert stats == dict(tests=36 * int((t_max > 0.0).sum()), passes=passes,
                         takes=takes)
    assert sm.dense_ops(stats) == 39 * stats["tests"] + 2 * passes + 2 * takes
