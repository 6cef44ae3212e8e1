"""The contract a class-sorted shade kernel rests on, held on the CPU, and
the operation tally behind the shade kernel's bound in ``chip_smoke.py``.

The design measured on the card (``chip_ab.py``'s ``shade`` part; PERF.md
§6) takes 128-lane tiles; where every 32 consecutive lanes of a tile
share a class it shades them in order, else it sorts the tile by class
(dead, then 1 + 2 x material type + 1 on a sphere) with a stable counting
sort, and each lane's planes come from and go to its own index.  It
measured slower than wave order, so ``shade_kernel`` keeps wave order;
``chip_ab.py`` still times the kernel on lanes sorted by class, which this
contract makes a like-for-like comparison.  Rendered
here in plain PyTorch on the lanes path_li hands the shade step at bounces
0 and 4 of a reduced colonnade (spheres, matte, metal and glossy
materials, dead and missed lanes), under both samplers:
``shade_planes_plain`` on the lanes in the kernel's order, permuted back,
equals the planes in wave order bit for bit.  ``shade_ops`` counts each
lane's own branch.  Imports no JAX.
"""

import dataclasses
import importlib.util
import os

import pytest
import torch
from torch.overrides import TorchFunctionMode

import torch_parity as tp
from yuki_tpu_torch.film import FilmSettings
from yuki_tpu_torch.integrators import PathParams
from yuki_tpu_torch.ops import shade_fused as tsf
from yuki_tpu_torch.renderer import render_frame
from yuki_tpu_torch.sampling import StratifiedSampler, UniformSampler

torch.set_num_threads(2)

TILE = 128
GROUP = 32
N_CLASSES = 9


def _smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_shade", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def calls():
    """{sampler: [shade_planes arguments of bounces 0-4]} of the first
    wave of a 64x48 reduced-colonnade frame (12 tiles, 3072 lanes)."""
    sm = _smoke()
    scene, cam = tp.port_scene("reduced")
    fs = FilmSettings(res=(64, 48), tile_dim=16)
    out = {}
    for name, sam in (("uniform", UniformSampler(1)),
                      ("strat", StratifiedSampler(2, 2))):
        out[name] = sm._capture(torch, lambda: render_frame(
            scene, cam, fs, sam, PathParams(5), wave_tiles=12, seed=1),
            {(tsf, "shade_planes"): 5})["shade_planes"]
    return sm, out


def lane_class(tb, rh, prim):
    """The kernel's shade_class: 0 dead (not alive and hit), else
    1 + 2 mtype + 1 on a sphere's surface."""
    alive = rh[tsf._RH["alive"]] > 0.0
    sph = rh[tsf._RH["sph"]]
    mid = tb.trs[prim.clamp(min=0).long(), 26]
    on = torch.zeros_like(alive)
    if tb.n_spheres:
        si = sph.clamp(0, tb.n_spheres - 1).long()
        on = (sph >= 0.0) & (sph < tb.n_spheres) & (si.float() == sph)
        mid = torch.where(on, tb.sp[si, 34], mid)
    mtype = tb.mat[mid.clamp(min=0.0).long(), 0].long().clamp(0, 3)
    return torch.where(alive, 1 + 2 * mtype + on.long(), 0)


def kernel_order(cls):
    """The lanes in the order the kernel shades them: per tile, in order
    where every 32-lane group holds one class, else by class, each class
    in lane order.  Returns (order, tiles sorted)."""
    order, sorted_tiles = [], 0
    for base in range(0, cls.numel(), TILE):
        c = cls[base:base + TILE]
        groups = torch.split(c, GROUP)
        if all(bool((g == g[0]).all()) for g in groups):
            order.append(torch.arange(base, base + c.numel()))
            continue
        sorted_tiles += 1
        order.append(base + torch.argsort(c, stable=True))
    return torch.cat(order), sorted_tiles


@pytest.mark.parametrize("sampler", ["uniform", "strat"])
@pytest.mark.parametrize("bounce", [0, 4])
def test_class_sorted_tiles_keep_every_plane(calls, sampler, bounce):
    """The planes of the lanes shaded in the kernel's order, permuted
    back, equal the planes in wave order bit for bit; bounce 4's tiles mix
    dead, missed and live lanes of several classes and get sorted."""
    _, by_sampler = calls
    tb, rh, prim, ph, texp, dim0, b = by_sampler[sampler][bounce][:7]
    spl = by_sampler[sampler][bounce][7]
    assert b == bounce and (spl is None) == (sampler == "uniform")
    cls = lane_class(tb, rh, prim)
    order, sorted_tiles = kernel_order(cls)
    inv = torch.argsort(order)
    ref = tsf.shade_planes_plain(tb, rh, prim, ph, texp, dim0, bounce, spl)

    def cols(x):
        return None if x is None else x[..., order].contiguous()
    got = tsf.shade_planes_plain(tb, cols(rh), cols(prim), cols(ph),
                                 cols(texp), dim0, bounce, cols(spl))
    assert torch.equal(got[:, inv].view(torch.int32), ref.view(torch.int32))
    counts = torch.bincount(cls, minlength=N_CLASSES)
    assert int((counts > 0).sum()) >= 3
    assert tb.n_spheres > 0 and int(counts[2::2].sum()) > 0  # sphere lanes
    if bounce == 4:
        assert int(counts[0]) > 0 and sorted_tiles > 0
        assert not torch.equal(order, torch.arange(cls.numel()))


class _Tally(TorchFunctionMode):
    """chip_smoke.shade_ops' count: FP32 adds, subtracts, multiplies,
    divides, reciprocals, square roots, min/max/clamps and the
    transcendentals, one for each element of each result."""

    OPS = {"add", "sub", "mul", "div", "__radd__", "__rsub__", "__rmul__",
           "__rdiv__", "__rtruediv__", "reciprocal", "sqrt", "minimum",
           "maximum", "clamp", "log", "sin", "cos"}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (getattr(func, "__name__", "") in self.OPS
                and isinstance(out, torch.Tensor) and out.is_floating_point()):
            self.n += out.numel()
        return out


def _groups(tb, rh, prim, texp):
    """Each lane's branch: (material type, sigma, sphere id or -1)."""
    sph = rh[tsf._RH["sph"]]
    mid = tb.trs[prim.clamp(min=0).long(), 26]
    sid = torch.full_like(prim, -1, dtype=torch.int64)
    si = sph.clamp(0, tb.n_spheres - 1).long()
    on = (sph >= 0.0) & (sph < tb.n_spheres) & (si.float() == sph)
    mid = torch.where(on, tb.sp[si, 34], mid)
    sid = torch.where(on, si, -1)
    mrow = tb.mat[mid.clamp(min=0.0).long()]
    s0 = mrow[:, 7] if texp is None else texp[3]
    sig = (s0 != 0.0) & tb.has_sigma
    return [(int(m), bool(g), int(s)) for m, g, s in zip(
        mrow[:, 0].long().clamp(0, 3), sig, sid)]


@pytest.mark.parametrize("bounce", [0, 4])
def test_shade_ops_counts_each_lanes_branch(calls, bounce):
    """shade_ops sums, over the lanes' branches, the plain version's count
    on one of a branch's lanes with that branch's statics alone times the
    branch's lanes (on more lanes the plain version makes a light's
    table arithmetic once for all, the kernel once a lane); with every
    lane running every branch the plain version counts more."""
    sm, by_sampler = calls
    tb, rh, prim, ph, texp, dim0, _, spl = by_sampler["strat"][bounce]
    ops = sm.shade_ops(torch, tsf, tb, rh, prim, ph, texp, dim0, bounce, spl)
    groups = _groups(tb, rh, prim, texp)
    total = 0
    for m, sig, s in sorted(set(groups)):
        lanes = torch.tensor([i for i, g in enumerate(groups)
                              if g == (m, sig, s)])
        one = dataclasses.replace(
            tb, present=frozenset({m}), has_sigma=sig,
            n_spheres=1 if s >= 0 else 0,
            sp=tb.sp[s:s + 1] if s >= 0 else tb.sp[:1])
        r = rh[:, lanes].clone()
        if s >= 0:
            r[tsf._RH["sph"]] = 0.0
        with _Tally() as all_lanes:
            tsf.shade_planes_plain(one, r, prim[lanes], ph[lanes], None,
                                   dim0, bounce, spl[:, lanes])
        with _Tally() as first:
            tsf.shade_planes_plain(one, r[:, :1], prim[lanes[:1]],
                                   ph[lanes[:1]], None, dim0, bounce,
                                   spl[:, lanes[:1]])
        assert 0 < all_lanes.n <= first.n * lanes.numel()
        assert 300 < first.n < 3000
        total += first.n * lanes.numel()
    assert ops == total
    with _Tally() as every:
        tsf.shade_planes_plain(tb, rh, prim, ph, texp, dim0, bounce, spl)
    assert ops < every.n
