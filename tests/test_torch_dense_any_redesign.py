"""The contracts the redesigned dense occlusion sweep
(yuki_tpu_torch/ops/csrc/trace_dense.cu, ``dense_any_kernel``) rests on,
held on the CPU against the plain version it is compared with on the
card.

The kernel's sweep, rendered here in plain PyTorch: the triangles staged
as copies whose corners are permuted for each shear frame, a ray's test
on its frame's copy from its origin in that frame (9 subtracts, no
selects), the closest sweep's test up to its range test against the
lane's t_max and no divide (the hit needs no t, b0 or b1); a triangle of
the lane's skip light passed over untested; a lane stopping at its first
occluder; lanes with t_max <= 0 never testing and NaN ones staying live.
On rays from random origins in every direction (all three frames),
axis-parallel lanes, exact ties between duplicated triangles, skip ids
-2, 0 and 1 and t_max finite, 0, -1 and NaN, each test's verdict equals
``watertight``'s hit (trace.py:159-171) and the sweep equals
``any_trace_plain`` bit for bit; the sweep cut before a lane's first
occluder does not.  Imports no JAX.
"""

import importlib.util
import os

import pytest
import torch

from test_torch_dense_redesign import FRAMES, N, _Tally, _test, soup
from yuki_tpu_torch.ops import trace as ttr
from yuki_tpu_torch.ops.trace import ray_shear

torch.set_num_threads(2)


def framed(tris, o, d):
    """The rays' shear and frame, their origins in their frame and the
    triangles' three permuted copies [T, 3 frames, 3 corners, 3]."""
    x_max, y_max, sx, sy, inv_dz = ray_shear(d[:, 0], d[:, 1], d[:, 2])
    frame = torch.where(x_max, 1, torch.where(y_max, 2, 0))
    of = torch.gather(o, 1, torch.as_tensor(FRAMES)[frame])
    corners = tris[:, :9].reshape(-1, 3, 3)
    copies = torch.stack([corners[:, :, list(p)] for p in FRAMES], dim=1)
    return (sx, sy, inv_dz), frame, of, copies


def framed_any_sweep(tris, light, o, d, t_max, skip, n_sweep=None):
    """dense_any_kernel's sweep over the first ``n_sweep`` triangles (all
    when None): (occluded [N] bool, tests [N] i64 each lane made)."""
    shear, frame, of, copies = framed(tris, o, d)
    live = ~(t_max <= 0.0)
    occ = torch.zeros_like(live)
    tests = torch.zeros(t_max.shape, dtype=torch.int64)
    n_sweep = tris.shape[0] if n_sweep is None else n_sweep
    for i in range(n_sweep):
        at = torch.nonzero(live & ~occ & (light[i] != skip)).squeeze(1)
        passed = _test(copies[i][frame[at]], of[at], *(x[at] for x in shear),
                       t_max[at])[0]
        tests[at] += 1
        occ[at[passed]] = True
    return occ, tests


@pytest.mark.parametrize("n_tris", [1, 36, 300])
def test_framed_any_sweep_matches_plain(n_tris):
    """The kernel's sweep equals any_trace_plain bit for bit, and counts
    the tests its tally says; cut before the last lane's first occluder,
    it differs."""
    tris, light, o, d, t_max, sk = soup(n_tris, 31 + n_tris)
    stats = {}
    ref = ttr.any_trace_plain(tris, light, o, d, t_max, sk, stats)
    got, tests = framed_any_sweep(tris, light, o, d, t_max, sk)
    assert torch.equal(got, ref)
    assert int(tests[t_max > 0.0].sum()) == stats["tests"]
    assert int(ref.sum()) > N // 20
    assert not bool(ref[~(t_max > 0.0) & ~torch.isnan(t_max)].any())
    x_max, y_max = ray_shear(d[:, 0], d[:, 1], d[:, 2])[:2]
    assert min(int(x_max.sum()), int(y_max.sum()),
               int((~x_max & ~y_max).sum())) > N // 5
    # Each lane's first occluder; cut the sweep before the last of them.
    first = torch.full_like(sk, n_tris, dtype=torch.int64)
    for i in reversed(range(n_tris)):
        one = ttr.any_trace_plain(tris[i:i + 1], light[i:i + 1], o, d, t_max,
                                  sk)
        first = torch.where(one, i, first)
    assert torch.equal(first < n_tris, ref)
    cut = int(first[ref].max())
    early, _ = framed_any_sweep(tris, light, o, d, t_max, sk, cut)
    assert not torch.equal(early, ref)


@pytest.mark.parametrize("t_fill", ["finite", "zero", "negative", "nan"])
def test_framed_test_is_watertights_hit(t_fill):
    """Every (ray, triangle) verdict of the framed, divide-free test equals
    watertight's hit (trace.py:159-171) at t_max finite, 0, -1 and NaN,
    duplicated triangles and axis-parallel lanes included."""
    tris, _, o, d, t_max, _ = soup(36, 7)
    t_max = {"finite": t_max.nan_to_num(nan=2.5).clamp(min=0.5),
             "zero": torch.zeros_like(t_max),
             "negative": torch.full_like(t_max, -1.0),
             "nan": torch.full_like(t_max, float("nan"))}[t_fill]
    shear, frame, of, copies = framed(tris, o, d)
    pre = ray_shear(d[:, 0], d[:, 1], d[:, 2])
    hits = 0
    for i in range(tris.shape[0]):
        got = _test(copies[i][frame], of, *shear, t_max)[0]
        ref = ttr.watertight(o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                             d[:, 2], t_max, tris[i, :9].unbind(0), pre)[0]
        assert torch.equal(got, ref), f"triangle {i}"
        hits += int(ref.sum())
    if t_fill in ("finite", "nan"):
        assert hits > 0  # a NaN t_max misses no range compare: lanes stay live
    else:
        assert hits == 0


def test_dense_any_bound_tally():
    """chip_smoke.py's operations behind the dense occlusion sweep's
    bound: the test up to its range test, counted on the rendering above
    for one ray and one triangle, times any_trace_plain's tests (each
    live lane's triangles up to its first occluder, its skip light's
    passed over)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_any", path)
    sm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sm)
    q = torch.tensor([[[0.1, 0.2, 2.0], [1.0, 0.1, 2.1], [0.2, 1.0, 2.2]]])
    one = [torch.tensor([x]) for x in (0.3, -0.2, 0.5, 5.0)]
    with _Tally() as tally:
        _test(q, torch.zeros((1, 3)), *one)
    assert tally.n == sm.OPS_DENSE_TEST

    tris, light, o, d, t_max, sk = soup(36, 5)
    stats = {}
    ttr.any_trace_plain(tris, light, o, d, t_max, sk, stats)
    _, tests = framed_any_sweep(tris, light, o, d, t_max, sk)
    live = t_max > 0.0
    assert stats["tests"] == int(tests[live].sum())
    assert stats["tests"] < 36 * int(live.sum())
    assert sm.any_ops(stats) == sm.OPS_DENSE_TEST * stats["tests"]
