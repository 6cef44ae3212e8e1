"""The port's dense path_li route end to end: make_wave_renderer -> camera
rays -> integrators.path_li over the dense sweeps (ops/trace.py) ->
shade, occlusion sweep, resolve per bounce, on the CPU, held against
yuki_tpu's make_wave_renderer with its fused wave off (PATH_FUSED_MODE
"off"), its dense queries on its dense Pallas kernels and its fused shade
kernels, both in interpret mode (torch_parity.render_path_li_both), under
_assert_parity's bounds with equal ray counts.  Two scenes: midsize
(under the fused wave's gate, so both sides switch the wave off) and a lit
2000-triangle soup (past the gate: path_li is the only route)."""

import numpy as np
import pytest
import torch

import torch_parity as tp

torch.set_num_threads(2)

# midsize at depth <= 2: yuki_tpu's jitted render contracts FMAs in its
# sphere test and shading, so the brass sphere's pixels differ by up to
# 2.2e-5 (30 of 768 at depth 1, measured on the CPU); every other pixel is
# held to 2e-6.
RTOL_SHALLOW = {"midsize": 5e-5, "lit-soup": 2e-6}


@pytest.mark.parametrize("name,depth", [("midsize", 2), ("lit-soup", 2),
                                        ("lit-soup", 5)])
def test_dense_path_li_matches_jax(name, depth):
    ref, rays_ref, got, rays_got = tp.render_path_li_both(name, depth)
    assert np.isfinite(got).all() and got.mean() > 0
    assert rays_got == rays_ref
    tp.assert_parity(ref, rays_ref, got, rays_got, depth,
                     rtol_shallow=RTOL_SHALLOW[name])
