"""The port's bundle walker's occlusion walk (yuki_tpu_torch/ops/
trace_walker.py walker_any_w) against yuki_tpu's walker_any_w, run op by op
as in test_torch_walker.py: occlusion, overflow and ok bit for bit, with a
skip light (chunk rows carry area-light ids -1, 0 and 1, rays skip -2, 0
or 1) and two budget tiers, lists cut at a small C, and a blown budget."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from test_torch_walker import N, _words, soup, walker_rays  # noqa: F401
from yuki_tpu.ops import trace_walker as jtw
from yuki_tpu_torch.ops import trace_walker as tw

torch.set_num_threads(2)


@pytest.mark.parametrize("case", ["skip light", "overflow", "blown"])
def test_walker_any_matches_jax(soup, case):
    _, jch, _, tch = soup
    o, d, t_max = walker_rays(soup, 4, 2.5)
    skip = np.random.default_rng(4).choice([-2, 0, 1], N).astype(np.int32)
    kw = {"skip light": dict(C=64, mult=16, mult_wide=32),
          "overflow": dict(C=4, mult=8),
          "blown": dict(C=64, mult=1)}[case]
    jw, tw_ = _words(jch, o, d, t_max)
    with tp.eager_grid_pallas():
        ref = jtw.walker_any_w(jch, jw, *(jnp.asarray(x) for x in
                                          (o, d, t_max, skip)),
                               interpret=True, **kw)
    got = tw.walker_any_w(tch, tw_, *(torch.as_tensor(x) for x in
                                      (o, d, t_max, skip)), **kw)
    assert bool(ref[2]) == got[2] == (case != "blown")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    if case == "blown":
        return
    occ = got[0].numpy()
    np.testing.assert_array_equal(occ, np.asarray(ref[0]))
    assert occ.any() and not occ.all()
    assert tw.LAUNCHES["walker_any"] == 0  # CPU tensors: plain version
