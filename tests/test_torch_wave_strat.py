"""The port's dense wave with a StratifiedSampler: the plain wave
(3x3 strata) against yuki_tpu's fused wave in Pallas interpret mode at
depth 1 (depth 3 is in test_torch_wave_strat_deep.py, as each JAX
interpret render compiles for ~30 s); and the one-kernel wave
(PATH_FUSED_ONEKERNEL) against the two-kernel wave, bit for bit, for both
samplers.  The strat variants of the raygen and bounce bodies are held
against yuki_tpu's in test_torch_wave_strat_bodies.py.

yuki_tpu's wave runs under jit, where XLA contracts FMAs (see
test_torch_wave.py) and turns the sampler's divides by a constant stratum
count into multiplies by its reciprocal, an ulp off the IEEE divide the
sampler asks for and the port does; hence the shallow rtol of
test_torch_wave.py for the whole wave.  (With 2x2 strata, 3 of the
wave's 2304 depth-1 values pass even that rtol.)"""

import numpy as np
import pytest
import torch

import torch_parity as tp
from yuki_tpu_torch.camera import Camera
from yuki_tpu_torch.integrators import PathParams
from yuki_tpu_torch.ops import path_fused as tpf
from yuki_tpu_torch.renderer import make_wave_renderer
from yuki_tpu_torch.sampling import StratifiedSampler, UniformSampler

torch.set_num_threads(2)


def test_wave_strat_matches_jax_cornell_depth1():
    ref, rays_ref, got, rays_got = tp.render_both(1, strat=(3, 3))
    assert np.isfinite(got).all() and got.mean() > 0
    tp.assert_parity(ref, rays_ref, got, rays_got, 1, rtol_shallow=2e-5)


@pytest.mark.parametrize("sampler", [UniformSampler(4),
                                     StratifiedSampler(2, 2)],
                         ids=["uniform", "stratified"])
def test_one_kernel_wave_equals_two_kernel_wave(sampler):
    scene, cam = tp.port_scene("cornell")
    render = make_wave_renderer(scene, Camera.create(cam, *tp.RES), sampler,
                                PathParams(max_depth=5), tp.TD, tp.TILES)
    assert tpf.PATH_FUSED_ONEKERNEL is False
    out = {}
    for one in (False, True):
        tpf.PATH_FUSED_ONEKERNEL = one
        try:
            tpf.reset_launches()
            out[one] = [render(tp.ORIGINS, si, 3) for si in (0, 3)]
        finally:
            tpf.PATH_FUSED_ONEKERNEL = False
        assert tpf.LAUNCHES == {"raygen_trace": 0, "bounce": 0, "wave": 0}
    for (px2, n2), (px1, n1) in zip(out[False], out[True]):
        assert float(n1) == float(n2) > tp.TILES * tp.TD * tp.TD
        np.testing.assert_array_equal(px1.numpy().view(np.uint32),
                                      px2.numpy().view(np.uint32))
    assert not np.array_equal(out[True][0][0].numpy(),
                              out[True][1][0].numpy())


def test_strat_planes_layout():
    """strat_planes stacks yuki_tpu's order: dims 0-1, then per bounce 2
    per light, 2 for the BSDF sample and 1 for roulette, each the
    sampler's own value."""
    from yuki_tpu_torch.sampling import SampleCtx

    sam = StratifiedSampler(3, 3)
    px = torch.arange(40, dtype=torch.int32)
    py = torch.arange(40, dtype=torch.int32) % 7
    n_lights, depth = 2, 3
    spl = tpf.strat_planes(sam, px, py, 4, 9, n_lights, depth)
    assert spl.shape == (2 + depth * (2 * n_lights + 3), 40)
    assert tpf.strat_planes(UniformSampler(1), px, py, 4, 9, 2, 3) is None
    ctx = SampleCtx(px=px, py=py, sample_index=4, seed=9)
    assert torch.equal(spl[0:2], sam.get_2d(ctx, 0).t())
    d0 = 2 + 2 * 7  # bounce 2
    assert torch.equal(spl[d0 + 2:d0 + 4], sam.get_2d(ctx, d0 + 2).t())
    assert torch.equal(spl[d0 + 4:d0 + 6], sam.get_2d(ctx, d0 + 4).t())
    assert torch.equal(spl[d0 + 6], sam.get_1d(ctx, d0 + 6))
