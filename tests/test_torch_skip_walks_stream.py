"""The plain skip-light slot and bundle walks of the port against
yuki_tpu's kernels, bit for bit: the ``with_skip`` variants of the slot
walk (``stream_closest_l``, the skip id on stream float 7) and of the
bundle walk (``walker_closest_w``, the ray table's column 7), run as
test_torch_skip_walks.py runs the dense and row walks (its inputs, and
yuki_tpu's kernels step by step and op by op under
torch_parity.eager_grid_pallas).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from test_torch_skip_walks import (_assert_equal, _j, _rays,
                                   _skipped_somewhere, _t, soup)  # noqa: F401
from yuki_tpu.ops import trace_stream as jts
from yuki_tpu.ops import trace_walker as jtw
from yuki_tpu_torch.ops import trace_cull as tcu
from yuki_tpu_torch.ops import trace_stream as ts
from yuki_tpu_torch.ops import trace_walker as tw

torch.set_num_threads(2)


@pytest.mark.parametrize("C", [64, 4])
def test_slot_skip_matches_jax(soup, C):
    """The slot walk's with_skip variant (skip on stream float 7) over the
    exact per-ray lists; C = 4 cuts some (overflow), C = 64 none."""
    _, jch, _, tch = soup
    o, d, t_max, skip = _rays(soup, 4)
    lists, ov = tcu.candidate_lists_2l(tch, *_t(o, d, t_max), C)
    with tp.eager_grid_pallas():
        ref = jts.stream_closest_l(
            jch, jnp.asarray(lists.numpy()), jnp.asarray(ov.numpy()),
            *_j(o, d, t_max), C=C, mult=8, interpret=True,
            skip=jnp.asarray(skip))
    got = ts.stream_closest_l(tch, lists, ov, *_t(o, d, t_max), C=C, mult=8,
                              skip=torch.as_tensor(skip))
    assert bool(ref[3]) and got[3]
    _assert_equal(ref[:3], got[:3], "t", "prim", "overflow")
    assert bool(ov.any()) == (C == 4)
    plain = ts.stream_closest_l(tch, lists, ov, *_t(o, d, t_max), C=C,
                                mult=8)
    _skipped_somewhere(got[1].numpy(), plain[1].numpy())


def test_walker_skip_matches_jax(soup):
    """The bundle walk's with_skip variant (the ray table's column 7),
    with the dispatch's two budget tiers."""
    _, jch, _, tch = soup
    o, d, t_max, skip = _rays(soup, 6, n=128)
    jw = jts._cross_words_xla(jch, *_j(o, d, t_max))
    tw_ = torch.as_tensor(np.asarray(jw).astype(np.int64))
    kw = dict(C=64, mult=24, mult_wide=48)
    with tp.eager_grid_pallas():
        ref = jtw.walker_closest_w(jch, jw, *_j(o, d, t_max), interpret=True,
                                   skip=jnp.asarray(skip), **kw)
    got = tw.walker_closest_w(tch, tw_, *_t(o, d, t_max),
                              skip=torch.as_tensor(skip), **kw)
    assert bool(ref[3]) and got[3]
    _assert_equal(ref[:3], got[:3], "t", "prim", "overflow")
    plain = tw.walker_closest_w(tch, tw_, *_t(o, d, t_max), **kw)
    _skipped_somewhere(got[1].numpy(), plain[1].numpy())
