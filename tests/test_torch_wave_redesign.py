"""The tile order of the redesigned one-kernel wave
(yuki_tpu_torch/ops/csrc/path_fused.cu, ``wave_kernel``), held on the CPU
against the plain wave it is compared with on the card.

The kernel takes a tile of 1024 lanes a block and keeps the tile's path
state in shared memory.  After raygen, each bounce sorts the tile's lanes
by class (missed, then the hit's material type and surface) with a stable
counting sort, leaves dead lanes out of the order, runs the bounce body on
the sorted live lanes alone (each at its own index: its hash and its
stratified planes), and the tile's loop ends after max_depth bounces or
when no lane is live.  ``tile_wave`` renders that order in plain PyTorch
with ``raygen_trace_plain`` and ``bounce_plain`` on the sorted live lanes;
it gives ``wave_plain``'s radiance and ray count bit for bit (dead lanes
keep theirs), every live lane runs each bounce exactly once and no dead
lane runs, under UniformSampler and a StratifiedSampler, at a lane count
that is not a multiple of the tile and on a tile whose lanes all die at
bounce 0.  Imports no JAX.
"""

import numpy as np
import pytest
import torch

from test_torch_cuda import DEPTH, RES, _setup
from yuki_tpu_torch.ops import path_fused as tpf
from yuki_tpu_torch.sampling import StratifiedSampler

torch.set_num_threads(2)

TILE = 1024  # path_fused.cu WAVE_TILE


def lane_class(tb, st):
    """lane_class of path_fused.cu: 0 dead, 1 missed, else 2 + 2 * the
    hit's material type (clamped to 0-3) + 1 on a sphere's surface."""
    S = tpf._ST
    alive = st[S["alive"]] > 0.0
    hitf = st[S["hitf"]] > 0.0
    sph = st[S["sph"]]
    mid = tb.trs[st[S["prim"]].clamp(min=0.0).long(), 26]
    on_sphere = torch.zeros_like(alive)
    if tb.n_spheres:
        si = sph.clamp(0, tb.n_spheres - 1).long()
        on_sphere = (sph >= 0.0) & (sph < tb.n_spheres) & (si.float() == sph)
        mid = torch.where(on_sphere, tb.sp[si, 34], mid)
    mtype = tb.mat[mid.clamp(min=0.0).long(), 0].long().clamp(0, 3)
    return torch.where(~alive, 0, torch.where(
        ~hitf, 1, 2 + 2 * mtype + on_sphere.long()))


def tile_wave(px, py, si, seed, tb, spl):
    """The wave kernel's order: ([4, N] radiance rgb and ray count, runs
    [max_depth, N] (how often each lane ran each bounce), the bounces each
    tile's loop made)."""
    st, ph = tpf.raygen_trace_plain(px, py, si, seed, tb,
                                    None if spl is None else spl[:2])
    n = px.shape[0]
    runs = torch.zeros((tb.max_depth, n), dtype=torch.int64)
    loops = []
    for base in range(0, n, TILE):
        lanes = torch.arange(base, min(base + TILE, n))
        made = 0
        for b in range(tb.max_depth):
            cls = lane_class(tb, st[:, lanes])
            live = cls > 0
            if not bool(live.any()):
                break
            order = lanes[live][torch.argsort(cls[live], stable=True)]
            planes = tpf._bounce_planes(spl, tb, b)
            st[:, order] = tpf.bounce_plain(
                st[:, order], ph[order], b, tb,
                None if planes is None else planes[:, order])
            runs[b, order] += 1
            made += 1
        loops.append(made)
    return st[[tpf._ST[k] for k in ("rx", "ry", "rz", "rc")]], runs, loops


def _alive_before(px, py, si, seed, tb, spl):
    """[max_depth, N]: each lane's alive flag entering each bounce, from
    the two-kernel plain wave."""
    st, ph = tpf.raygen_trace_plain(px, py, si, seed, tb,
                                    None if spl is None else spl[:2])
    alive = []
    for b in range(tb.max_depth):
        alive.append(st[tpf._ST["alive"]] > 0.0)
        st = tpf.bounce_plain(st, ph, b, tb, tpf._bounce_planes(spl, tb, b))
    return torch.stack(alive)


def _missing_pixels(tb, n, si, seed, sampler):
    """n pixels whose camera rays of sample ``si`` hit nothing, in film
    order, repeated as needed (a stratified value depends on the pixel, sample and dimension
    alone, so these rays are the same in any wave)."""
    h, w = RES[1], RES[0]
    dev = tb.device
    py, px = torch.meshgrid(torch.arange(h, dtype=torch.int32, device=dev),
                            torch.arange(w, dtype=torch.int32, device=dev),
                            indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    spl = tpf.strat_planes(sampler, px, py, si, seed, tb.n_lights, DEPTH)
    st, _ = tpf.raygen_trace_plain(px, py, si, seed, tb,
                                   None if spl is None else spl[:2])
    miss = torch.nonzero(st[tpf._ST["hitf"]] == 0.0).squeeze(1)
    assert miss.numel() >= 256
    pick = miss[torch.arange(n, device=dev) % miss.numel()]
    return px[pick], py[pick]


@pytest.mark.parametrize("sampler", [None, StratifiedSampler(2, 2)],
                         ids=["uniform", "2x2"])
@pytest.mark.parametrize("name", ["cornell", "every-branch"])
def test_tile_order_gives_the_plain_waves_bits(name, sampler):
    """2,500 lanes (two whole tiles and a partial one); on every-branch the
    first tile's lanes all miss, so that tile's loop ends after bounce 0."""
    tb, px, py = _setup(name, "cpu", n=2500)
    si, seed = 2, 7
    if name == "every-branch":
        mx, my = _missing_pixels(tb, TILE, si, seed, sampler)
        px, py = torch.cat([mx, px[TILE:]]), torch.cat([my, py[TILE:]])
    spl = tpf.strat_planes(sampler, px, py, si, seed, tb.n_lights, DEPTH)
    ref = tpf.wave_plain(px, py, si, seed, tb, spl)
    got, runs, loops = tile_wave(px, py, si, seed, tb, spl)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    alive = _alive_before(px, py, si, seed, tb, spl)
    assert torch.equal(runs, alive.long())
    assert len(loops) == 3 and max(loops) == DEPTH
    if name == "every-branch":
        # One ray each: the camera ray, counted by raygen.
        assert loops[0] == 1 and torch.equal(ref[3, :TILE],
                                             torch.ones(TILE))
    # Lanes die along the way, and a dead lane's radiance and count stay
    # as its last bounce left them.
    assert 0 < int(alive[-1].sum()) < int(alive[0].sum())
    assert float(ref[3].sum()) > px.shape[0]
    assert np.isfinite(got.numpy()).all()
