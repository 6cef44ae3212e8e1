"""The port's whole wave (make_wave_renderer on the CPU, plain versions)
against yuki_tpu's fused wave in Pallas interpret mode: Cornell at
64x48, 8-pixel tiles, 12 tiles, depths 1 and 3.  Depth 5 and the clamp
are in test_torch_wave_deep.py and test_torch_wave_clamp.py: each JAX
interpret render compiles for ~30 s, so they are split across files.

At depth <= 2 _assert_parity asks rtol 2e-6.  Here the JAX wave runs
under jit, and XLA's CPU backend contracts a*b + c into FMAs in compiled
code (jit of a*b - c*d equals the FMA form on every input); the port,
like JAX's eager kernel bodies and the CUDA kernel, rounds each product.
That moves 3 of 2304 depth-1 values by up to 8.8e-6 relative, so the
shallow bound here is rtol 2e-5 with the ray counts still equal."""

import pytest
import torch

import torch_parity as tp

torch.set_num_threads(2)


@pytest.mark.parametrize("depth", [1, 3])
def test_wave_matches_jax_cornell(depth):
    ref, rays_ref, got, rays_got = tp.render_both(depth)
    tp.assert_parity(ref, rays_ref, got, rays_got, depth, rtol_shallow=2e-5)
