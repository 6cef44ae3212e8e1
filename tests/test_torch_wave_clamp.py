"""The port's whole wave against yuki_tpu's fused wave in Pallas
interpret mode with indirect_clamp=2.0 and samples_per_launch=2 (the sum
of two sample generations, added in sample order), depth 3."""

import torch

import torch_parity as tp

torch.set_num_threads(2)


def test_wave_matches_jax_clamp_spl():
    ref, rays_ref, got, rays_got = tp.render_both(3, spp=2, clamp=2.0,
                                                  spl=2)
    tp.assert_parity(ref, rays_ref, got, rays_got, 3)
