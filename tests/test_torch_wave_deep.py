"""The port's whole wave against yuki_tpu's fused wave in Pallas
interpret mode at depth 5, under the chaos-aware bounds (see
test_torch_wave.py)."""

import torch

import torch_parity as tp

torch.set_num_threads(2)


def test_wave_matches_jax_cornell_depth5():
    ref, rays_ref, got, rays_got = tp.render_both(5)
    tp.assert_parity(ref, rays_ref, got, rays_got, 5)
