"""The one-kernel dense wave (path_fused.wave, PATH_FUSED_ONEKERNEL) and
the stratified variants of the raygen, bounce and shade kernels, on the
card.  Marked ``cuda``: they skip where torch.cuda.is_available() is
False.  This file imports no JAX, so on the card it runs without the
repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_wave1k.py

The wave kernel runs the same device functions as the raygen and bounce
kernels on 1024-lane tiles whose state stays in shared memory, its live
lanes sorted by class at every bounce, so it must give the two-kernel
wave's bits.  Against the plain versions the rules of test_torch_cuda.py
hold (cos/sin/log may differ by an ulp between libdevice and torch).
"""

import numpy as np
import pytest
import torch

from test_torch_cuda import (CASES, DEPTH, FLOATS, N, RES, _plane, _setup,
                             cuda)  # noqa: F401
from test_torch_wave_redesign import TILE, _missing_pixels
from torch_scenes import wide_camera
from yuki_tpu_torch import camera as cam_mod
from yuki_tpu_torch import transforms as tf
from yuki_tpu_torch.camera import Camera
from yuki_tpu_torch.integrators import PathParams
from yuki_tpu_torch.ops import path_fused as tpf
from yuki_tpu_torch.sampling import StratifiedSampler
from yuki_tpu_torch.scene import data as scene_data

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)

SAMPLERS = [None, StratifiedSampler(2, 2), StratifiedSampler(3, 3)]


def _two_kernel(tb, px, py, si, seed, spl):
    """The two-kernel CUDA wave: [4, N] radiance rgb and ray count."""
    st, ph = tpf.raygen_trace(px, py, si, seed, tb,
                              None if spl is None else spl[:2])
    for b in range(DEPTH):
        st = tpf.bounce(st, ph, b, tb, tpf._bounce_planes(spl, tb, b))
    return st[[tpf._ST["rx"], tpf._ST["ry"], tpf._ST["rz"], tpf._ST["rc"]]]


@pytest.mark.parametrize("sampler", SAMPLERS, ids=["uniform", "2x2", "3x3"])
@pytest.mark.parametrize("name,clamp", CASES)
def test_wave_kernel_equals_two_kernel_wave(cuda, name, clamp, sampler):
    tb, px, py = _setup(name, cuda, clamp)
    si = 1 if sampler is None else sampler.samples_per_pixel - 1
    spl = tpf.strat_planes(sampler, px, py, si, 7, tb.n_lights, DEPTH)
    tpf.reset_launches()
    one = tpf.wave(px, py, si, 7, tb, spl)
    assert tpf.LAUNCHES == {"raygen_trace": 0, "bounce": 0, "wave": 1}
    two = _two_kernel(tb, px, py, si, 7, spl)
    torch.cuda.synchronize()
    assert torch.equal(one.view(torch.int32), two.view(torch.int32))
    assert float(one[3].sum()) > N


@pytest.mark.parametrize("sampler", SAMPLERS[1:], ids=["2x2", "3x3"])
def test_path_li_wave_one_kernel_flag(cuda, sampler):
    tb, px, py = _setup("cornell", cuda)
    ref = tpf.path_li_wave(tb, px, py, 0, 5, sampler)
    tpf.PATH_FUSED_ONEKERNEL = True
    try:
        tpf.reset_launches()
        got = tpf.path_li_wave(tb, px, py, 0, 5, sampler)
        assert tpf.LAUNCHES == {"raygen_trace": 0, "bounce": 0, "wave": 1}
    finally:
        tpf.PATH_FUSED_ONEKERNEL = False
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _wave_both(tb, px, py, si, seed, sampler):
    """The wave kernel's [4, N] and the two-kernel wave's, after checking
    that the wave took one launch."""
    spl = tpf.strat_planes(sampler, px, py, si, seed, tb.n_lights,
                           tb.max_depth)
    tpf.reset_launches()
    one = tpf.wave(px, py, si, seed, tb, spl)
    assert tpf.LAUNCHES == {"raygen_trace": 0, "bounce": 0, "wave": 1}
    st, ph = tpf.raygen_trace(px, py, si, seed, tb,
                              None if spl is None else spl[:2])
    for b in range(tb.max_depth):
        st = tpf.bounce(st, ph, b, tb, tpf._bounce_planes(spl, tb, b))
    two = st[[tpf._ST["rx"], tpf._ST["ry"], tpf._ST["rz"], tpf._ST["rc"]]]
    torch.cuda.synchronize()
    return one, two, spl


def _assert_plain_rules(got, ref):
    """test_wave_kernel_matches_plain's rules against wave_plain."""
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    assert np.isfinite(got).all()
    assert abs(got[3].sum() - ref[3].sum()) <= max(16, 0.01 * ref[3].sum())
    bad = (np.abs(got[:3] - ref[:3]) > 2e-4 + 2e-4 * np.abs(ref[:3])).any(0)
    assert bad.sum() <= max(4, got.shape[1] // 12)


@pytest.mark.parametrize("sampler", [None, StratifiedSampler(2, 2)],
                         ids=["uniform", "2x2"])
@pytest.mark.parametrize("n_spheres", [0, 3])
def test_wave_kernel_at_the_gate(cuda, n_spheres, sampler):
    """1024 triangles (the wave's gate: one camera copy at a time) on the
    wide camera, whose rays span the three shear frames; 1,500 lanes, not
    a multiple of the 1024-lane tile.  Bits of the two-kernel wave; the
    plain wave under the file's rules."""
    scene, cam = wide_camera(scene_data, tf, cam_mod, 1024, n_spheres,
                             seed=5 + n_spheres, device=cuda)
    tb = tpf.make_tables(scene, Camera.create(cam, *RES), PathParams(DEPTH))
    assert tb.n_tris == tpf.MAX_TRIS_WAVE
    rng = np.random.default_rng(n_spheres)
    n = 1500
    px = torch.as_tensor(rng.integers(0, RES[0], n, dtype=np.int32),
                         device=cuda)
    py = torch.as_tensor(rng.integers(0, RES[1], n, dtype=np.int32),
                         device=cuda)
    one, two, spl = _wave_both(tb, px, py, 3, 11, sampler)
    assert torch.equal(one.view(torch.int32), two.view(torch.int32))
    _assert_plain_rules(one, tpf.wave_plain(px, py, 3, 11, tb, spl))
    assert float(one[3].sum()) > n


@pytest.mark.parametrize("sampler", [None, StratifiedSampler(2, 2)],
                         ids=["uniform", "2x2"])
@pytest.mark.parametrize("n", [1, 1025, 2500])
def test_wave_kernel_ragged_and_dead_tiles(cuda, n, sampler):
    """Lane counts that are not a multiple of the tile, the first tile's
    lanes all missed at bounce 0 (dead after it: its loop ends there) and
    the rest on every-branch's random pixels.  Bits of the two-kernel wave;
    the plain wave under the file's rules."""
    tb, px, py = _setup("every-branch", cuda, n=n)
    si, seed = 2, 7
    mx, my = _missing_pixels(tb, min(n, TILE), si, seed, sampler)
    px, py = torch.cat([mx, px[TILE:]]), torch.cat([my, py[TILE:]])
    one, two, spl = _wave_both(tb, px, py, si, seed, sampler)
    assert torch.equal(one.view(torch.int32), two.view(torch.int32))
    _assert_plain_rules(one, tpf.wave_plain(px, py, si, seed, tb, spl))
    dead = one[:, :TILE]
    assert torch.equal(dead[3], torch.ones_like(dead[3]))


def test_wave_kernel_matches_plain(cuda):
    tb, px, py = _setup("every-branch", cuda)
    spl = tpf.strat_planes(StratifiedSampler(2, 2), px, py, 2, 9,
                           tb.n_lights, DEPTH)
    got = tpf.wave(px, py, 2, 9, tb, spl).cpu().numpy()
    ref = tpf.wave_plain(px, py, 2, 9, tb, spl).cpu().numpy()
    assert np.isfinite(got).all()
    assert abs(got[3].sum() - ref[3].sum()) <= max(16, 0.01 * ref[3].sum())
    bad = (np.abs(got[:3] - ref[:3]) > 2e-4 + 2e-4 * np.abs(ref[:3])).any(0)
    assert bad.sum() <= max(4, N // 12)
    np.testing.assert_allclose(got[:3].mean(), ref[:3].mean(), rtol=2e-3)


@pytest.mark.parametrize("name,clamp", CASES)
def test_strat_raygen_bounce_match_plain(cuda, name, clamp):
    tb, px, py = _setup(name, cuda, clamp)
    spl = tpf.strat_planes(StratifiedSampler(3, 3), px, py, 4, 11,
                           tb.n_lights, DEPTH)
    st_k, ph_k = tpf.raygen_trace(px, py, 4, 11, tb, spl[:2])
    st_p, ph_p = tpf.raygen_trace_plain(px, py, 4, 11, tb, spl[:2])
    torch.cuda.synchronize()
    assert torch.equal(ph_k, ph_p)
    for k in ("prim", "sph", "hitf"):
        np.testing.assert_array_equal(_plane(st_k, k), _plane(st_p, k), k)
    for k in ("ox", "oy", "oz", "dx", "dy", "dz", "t", "b0", "b1"):
        np.testing.assert_allclose(_plane(st_k, k), _plane(st_p, k),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    st = st_k
    for b in range(DEPTH):
        planes = tpf._bounce_planes(spl, tb, b)
        out_k = tpf.bounce(st, ph_k, b, tb, planes)
        out_p = tpf.bounce_plain(st, ph_k, b, tb, planes)
        torch.cuda.synchronize()
        for k in ("alive", "spec", "rc"):
            np.testing.assert_array_equal(_plane(out_k, k), _plane(out_p, k),
                                          f"bounce {b} {k}")
        for k in FLOATS:
            np.testing.assert_allclose(_plane(out_k, k), _plane(out_p, k),
                                       rtol=2e-6, atol=1e-7,
                                       err_msg=f"bounce {b} {k}")
        st = out_k


def test_strat_shade_matches_plain(cuda):
    """The shade kernel with a bounce's 2L+3 stratified planes, on the
    reduced colonnade's camera hits (path_li's own packing)."""
    from torch_scenes import REDUCED
    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.camera import Camera
    from yuki_tpu_torch.integrators import PathParams, _ph_i32
    from yuki_tpu_torch.ops import shade_fused as tsf
    from yuki_tpu_torch.ops.path_fused import bounce_draws
    from yuki_tpu_torch.sampling import SampleCtx
    from yuki_tpu_torch.scene.testscenes import colonnade

    sc, cam, _ = colonnade(device="cuda", **REDUCED)
    w, h = RES
    py, px = torch.meshgrid(torch.arange(h, device=cuda),
                            torch.arange(w, device=cuda), indexing="ij")
    px, py = px.reshape(-1).int(), py.reshape(-1).int()
    sam = StratifiedSampler(2, 2)
    ctx = SampleCtx(px=px, py=py, sample_index=3, seed=5)
    o, d = Camera.create(cam, w, h).ray(
        torch.stack([px.float(), py.float()], -1) + sam.get_2d(ctx, 0))
    o, d = o.contiguous(), d.contiguous()
    t_max = torch.full((o.shape[0],), traverse.F32_MAX, device=cuda)
    hit = traverse.intersect(sc.data, sc.meta, o, d, t_max)
    tables = tsf.make_shade_tables(sc, PathParams(DEPTH))
    n_lights = tables.n_lights
    spl = torch.stack(bounce_draws(sam, ctx, 2, n_lights)).contiguous()
    rh, prim = tsf.pack_shade(hit, o, d, torch.ones_like(o), hit.hit,
                              torch.zeros_like(hit.hit))
    texp = tsf.texture_planes(tables, prim, rh[tsf._RH["sph"]], hit.b0,
                              hit.b1)
    tsf.reset_launches()
    got = tsf.shade_planes(tables, rh, prim, _ph_i32(ctx), texp, 2, 0, spl)
    assert tsf.LAUNCHES["shade"] == 1
    ref = tsf.shade_planes_plain(tables, rh, prim, _ph_i32(ctx), texp, 2, 0,
                                 spl)
    uni = tsf.shade_planes(tables, rh, prim, _ph_i32(ctx), texp, 2, 0)
    torch.cuda.synchronize()
    flags = [tsf._OUT["alive2"], tsf._OUT["spec2"]] + [
        tsf._N_FIXED_OUT + tsf._N_PER_LIGHT * li + 7
        for li in range(n_lights)]
    for p in flags:
        assert torch.equal(got[p], ref[p]), p
    torch.testing.assert_close(got, ref, rtol=2e-6, atol=1e-7)
    assert not torch.equal(got, uni)
    assert int(hit.hit.sum()) > o.shape[0] // 4
