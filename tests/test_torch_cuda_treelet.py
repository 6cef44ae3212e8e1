"""The treelet path's CUDA kernels (treelet walks, shade, resolve) against
their plain PyTorch versions, on the card.  Marked ``cuda``: they skip
where torch.cuda.is_available() is False.  This file imports no JAX, so
on the card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_treelet.py

Both sides run on the same card.  The walks must agree bit for bit (same
visits, same rows, same op order, -fmad=false); shade planes to rtol 2e-6
/ atol 1e-7 (cos/sin/log ulps between libdevice and torch's CUDA
kernels); resolve exactly.
"""

import numpy as np
import pytest
import torch

from torch_scenes import REDUCED, textured_treelet
from yuki_tpu_torch import camera, traverse
from yuki_tpu_torch import transforms as tf
from yuki_tpu_torch.camera import Camera
from yuki_tpu_torch.film import FilmSettings
from yuki_tpu_torch.integrators import PathParams
from yuki_tpu_torch.ops import shade_fused as tsf
from yuki_tpu_torch.ops import trace_rows as trw
from yuki_tpu_torch.ops import trace_stream as tst
from yuki_tpu_torch.ops import trace_treelets as ttt
from yuki_tpu_torch.ops.trace import F32_MAX
from yuki_tpu_torch.renderer import make_wave_renderer, render_frame
from yuki_tpu_torch.sampling import UniformSampler
from yuki_tpu_torch.scene import data
from yuki_tpu_torch.scene.testscenes import colonnade

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)

RES = (64, 48)
TD = 8
ORIGINS = np.stack([np.arange(12, dtype=np.int32) % 4 * TD,
                    np.arange(12, dtype=np.int32) // 4 * TD], axis=1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _rays(scene, cam, n, seed, dev):
    """n camera rays through random pixels, then a quarter of them replaced
    by axis-parallel rays starting on box planes (the NaN slab case)."""
    rng = np.random.default_rng(seed)
    camera = Camera.create(cam, *RES)
    p = torch.as_tensor(rng.random((n, 2), np.float32)
                        * np.array(RES, np.float32), device=dev)
    o, d = camera.ray(p)
    o, d = o.contiguous().clone(), d.contiguous().clone()
    q = n // 4
    axis = rng.integers(0, 3, q)
    dd = np.zeros((q, 3), np.float32)
    dd[np.arange(q), axis] = rng.choice([-1.0, 1.0], q)
    lo = scene.data.treelets.treelet_bounds[:, :3].cpu().numpy()
    oo = lo[rng.integers(0, lo.shape[0], q)].copy()
    d[:q] = torch.as_tensor(dd, device=dev)
    o[:q] = torch.as_tensor(oo, device=dev)
    return o, d


def test_treelet_walks_match_plain(cuda):
    scene, cam, _ = colonnade(device=cuda, **REDUCED)
    tl = scene.data.treelets
    n = 3 * 1024 + 100  # a ragged last block
    o, d = _rays(scene, cam, n, 3, cuda)
    t_max = torch.full((n,), F32_MAX, device=cuda)
    t_max[::7] = 0.0  # parked lanes: tested and rejected
    ttt.reset_launches()
    got = ttt.treelet_closest(tl, o, d, t_max)
    ref = ttt.treelet_closest_plain(tl, o, d, t_max)
    torch.cuda.synchronize()
    assert ttt.LAUNCHES["treelet_closest"] == 1
    for g, r, name in zip(got, ref, ("t", "prim", "b0", "b1")):
        assert torch.equal(g, r), name
    assert int((got[1] >= 0).sum()) > n // 2
    chord = torch.full((n,), 3.0, device=cuda)
    for sk in (-2, -1, 0):
        skip = torch.full((n,), sk, dtype=torch.int32, device=cuda)
        occ = ttt.treelet_any(tl, o, d, chord, skip)
        occ_p = ttt.treelet_any_plain(tl, o, d, chord, skip)
        assert torch.equal(occ, occ_p), sk
        assert bool(occ.any()) == (sk != -1)


def test_shade_and_resolve_kernels_match_plain(cuda):
    scene, cam, _ = colonnade(device=cuda, **REDUCED)
    tb = tsf.make_shade_tables(scene, PathParams(5, indirect_clamp=2.0))
    n = 4096
    o, d = _rays(scene, cam, n, 5, cuda)
    rng = np.random.default_rng(9)
    ph = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
                         .astype(np.int32), device=cuda)
    from yuki_tpu_torch import traverse

    t_max = torch.full((n,), F32_MAX, device=cuda)
    hit = traverse.intersect(scene.data, scene.meta, o, d, t_max)
    beta = torch.as_tensor(rng.random((n, 3), np.float32) + 0.1, device=cuda)
    spec = torch.as_tensor(rng.random(n) < 0.3, device=cuda)
    rh, prim = tsf.pack_shade(hit, o, d, beta, hit.hit, spec)
    for b in (0, 2, 4):
        dim0 = 2 + b * (2 * tb.n_lights + 3)
        got = tsf.shade_planes(tb, rh, prim, ph, None, dim0, b)
        ref = tsf.shade_planes_plain(tb, rh, prim, ph, None, dim0, b)
        torch.cuda.synchronize()
        flags = [tsf._OUT["alive2"], tsf._OUT["spec2"]] + [
            tsf._N_FIXED_OUT + tsf._N_PER_LIGHT * li + 7
            for li in range(tb.n_lights)]
        for p in flags:
            assert torch.equal(got[p], ref[p]), f"bounce {b} plane {p}"
        torch.testing.assert_close(got, ref, rtol=2e-6, atol=1e-7)

    for n_lights, clamp in ((1, False), (2, False), (2, True)):
        rs = torch.as_tensor(rng.standard_normal((16, n)).astype(np.float32),
                             device=cuda)
        nee = torch.as_tensor(rng.standard_normal((5 * n_lights, n))
                              .astype(np.float32), device=cuda)
        for b in (0, 1):
            got = tsf.resolve_planes(rs, nee, n_lights, b, clamp)
            ref = tsf.resolve_planes_plain(rs, nee, n_lights, b, clamp)
            assert torch.equal(got, ref), (n_lights, clamp, b)


def test_path_li_render_kernels_match_plain(cuda):
    """One 12-tile wave of the 64x48 reduced colonnade, depth 5: kernels on
    the card against the plain versions on the CPU, under the chaos-aware
    bounds of tests/test_path_fused.py:58-81."""
    out = {}
    for dev in (cuda, torch.device("cpu")):
        scene, cam, _ = colonnade(device=dev, **REDUCED)
        render = make_wave_renderer(scene, Camera.create(cam, *RES),
                                    UniformSampler(1), PathParams(5), TD, 12)
        for m in (ttt, tsf, tst, trw):
            m.reset_launches()
        traverse.reset_counts()
        px, rays = render(ORIGINS, 0, 7)
        out[dev.type] = (px.cpu().numpy(), float(rays))
        if dev.type == "cuda":
            # Each bounce's two queries take the rows engine (coherent
            # wave) or the slot stream; the treelet walk runs only on a
            # counted fallback.
            c = traverse.counts()
            assert c["closest_slot"] + c["closest_rows"] == 5
            assert c["any_slot"] + c["any_rows"] == 5
            assert (trw.LAUNCHES["rows_closest"]
                    + tst.LAUNCHES["slot_closest"]) >= 5
            assert trw.LAUNCHES["rows_any"] + tst.LAUNCHES["slot_any"] >= 5
            assert sum(ttt.LAUNCHES.values()) == c["fallbacks"]
            assert tsf.LAUNCHES == {"shade": 5, "resolve": 5}
    (got, rays_k), (ref, rays_p) = out["cuda"], out["cpu"]
    assert np.isfinite(got).all()
    assert abs(rays_k - rays_p) <= max(16, 0.01 * rays_p)
    bad = (np.abs(got - ref) > 2e-4 + 2e-4 * np.abs(ref)).reshape(-1, 3)
    assert bad.any(-1).sum() <= max(4, bad.shape[0] // 12)
    np.testing.assert_allclose(got.mean(), ref.mean(), rtol=2e-3)


def test_treelet_wrappers_validate(cuda):
    scene, cam, _ = colonnade(device=cuda, **REDUCED)
    tl = scene.data.treelets
    o, d = _rays(scene, cam, 256, 1, cuda)
    t_max = torch.full((256,), F32_MAX, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        ttt.treelet_closest(tl, o.double(), d, t_max)
    with pytest.raises(ValueError, match="contiguous"):
        ttt.treelet_closest(tl, o.t().contiguous().t(), d, t_max)
    with pytest.raises(ValueError, match="skip_light"):
        ttt.treelet_any(tl, o, d, t_max, torch.zeros(256, device=cuda))


def test_render_frame_textured_treelet_scene(cuda):
    """A textured treelet scene renders through the kernels with the
    texture resolve as torch glue; finite and close to the CPU plain run."""
    imgs = []
    for dev in (cuda, torch.device("cpu")):
        scene, cam = textured_treelet(data, tf, camera, device=dev)
        res = render_frame(scene, cam, FilmSettings(res=(32, 24), tile_dim=8),
                           UniformSampler(1), PathParams(2), wave_tiles=12,
                           seed=3)
        imgs.append(res.film.image())
    assert np.isfinite(imgs[0]).all() and imgs[0].mean() > 0
    np.testing.assert_allclose(imgs[0], imgs[1], rtol=2e-6, atol=1e-7)
