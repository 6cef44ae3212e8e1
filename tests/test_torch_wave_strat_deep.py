"""The port's dense wave with StratifiedSampler(3, 3) against yuki_tpu's
fused wave in Pallas interpret mode at depth 3, under the chaos-aware
bounds (see test_torch_wave_strat.py).

At depth >= 2 one sample of a stratified wave leans on those bounds more
than the uniform wave does: yuki_tpu's own fused wave and its XLA path_li
chain, both compiled by XLA, disagree past 2e-4 on 7 of 768 lanes of the
2x2 sampler's first sample at depth 2, while the port's plain bodies hold
yuki_tpu's eager ones to rtol 2e-6 (test_torch_wave_strat.py); with the
2x2 sampler at depth 3 the mean of one sample then differs by 2.1e-3 (the
bound is 2e-3), over its four strata it stays inside."""

import numpy as np
import torch

import torch_parity as tp

torch.set_num_threads(2)


def test_wave_strat_matches_jax_cornell_depth3():
    ref, rays_ref, got, rays_got = tp.render_both(3, strat=(3, 3))
    assert np.isfinite(got).all() and got.mean() > 0
    tp.assert_parity(ref, rays_ref, got, rays_got, 3)
