"""The port's two-level cull (yuki_tpu_torch/ops/trace_cull.py) against
yuki_tpu's XLA twin trace_stream.candidate_lists_2l, which
tests/test_cull_fused.py holds bit for bit against the Pallas kernel:
lists and overflow flags bit for bit, on live rays, parked lanes, short
t_max, axis-parallel rays from box corners and forced overflow (small C
and S)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from yuki_tpu.ops import trace_cull as jtc
from yuki_tpu.ops import trace_stream as jts
from yuki_tpu_torch.ops import trace_cull as tcu
from yuki_tpu_torch.ops import trace_stream as ts
from yuki_tpu_torch.ops.trace import F32_MAX

torch.set_num_threads(2)

N = 768


@pytest.fixture(scope="module")
def soup():
    """1,100 triangles in 16-triangle chunks (4 words, the last partial)."""
    return tp.chunk_soup(1100, 29, 16)


def _rays(soup, seed, shrink=1.0):
    _, _, _, tch = soup
    o, d = tp.divergent_rays(N, seed, tch.treelet_bounds.numpy())
    o[N // 8:] *= shrink  # shrink < 1: rays through the soup's dense core
    rng = np.random.default_rng(seed)
    t_max = np.where(rng.random(N) < 0.2, 0.0,
                     np.where(rng.random(N) < 0.3, 0.8, F32_MAX))
    return o, d, t_max.astype(np.float32)


@pytest.mark.parametrize("C,S,shrink", [(16, 24, 1.0), (8, 6, 1.0),
                                        (4, 3, 0.05), (16, 2, 0.05)])
def test_cull_matches_jax(soup, C, S, shrink):
    _, jch, _, tch = soup
    o, d, t_max = _rays(soup, C + S, shrink)
    ref_l, ref_ov = jts.candidate_lists_2l(
        jch, *(jnp.asarray(x) for x in (o, d, t_max)), C, S=S)
    got_l, got_ov = tcu.candidate_lists_fused(
        tch, *(torch.as_tensor(x) for x in (o, d, t_max)), C, S)
    np.testing.assert_array_equal(got_ov.numpy(), np.asarray(ref_ov))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    assert (got_l.numpy()[t_max == 0.0] == -1).all()
    assert bool(got_ov.any()) == ((C, S) != (16, 24))
    assert tcu.LAUNCHES["cull"] == 0  # CPU tensors: the plain version


def test_cross_compact_matches_jax(soup):
    _, jch, _, tch = soup
    o, d, t_max = _rays(soup, 3, 0.05)
    ref = jts.cross_compact(jch, *(jnp.asarray(x) for x in (o, d, t_max)), 5)
    got = tcu.cross_compact(tch, *(torch.as_tensor(x) for x in (o, d, t_max)),
                            5)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r).astype(
            g.numpy().dtype))


def test_word_tables_match_jax(soup):
    """Level-1 word boxes (pad lo +inf, hi -inf) and level-2 chunk bounds
    (pad BIG) equal yuki_tpu's, as do the kernel's word boxes."""
    _, jch, _, tch = soup
    for g, r in zip(tcu._word_tables(tch), jts._word_tables(jch)):
        np.testing.assert_array_equal(g.reshape(np.asarray(r).shape).numpy(),
                                      np.asarray(r))
    w = ts.n_words(tch.n_treelets)
    wb, _, _ = jtc._word_tables_kernel(jch)
    np.testing.assert_array_equal(tcu._word_tables_kernel(tch)[:, :6].numpy(),
                                  np.asarray(wb)[:w, :6])


def test_lists_are_the_crossed_chunks(soup):
    """For rays that do not overflow, the list is the crossing words' set
    bits: the same lists as cross_words + extract_lists."""
    _, _, _, tch = soup
    o, d, t_max = (torch.as_tensor(x) for x in _rays(soup, 5))
    lists, ov = tcu.candidate_lists_2l(tch, o, d, t_max, 64)
    ref, ref_ov = ts.extract_lists(ts.cross_words(tch, o, d, t_max), 64)
    assert not ov.any() and not ref_ov.any()
    assert torch.equal(lists, ref)
