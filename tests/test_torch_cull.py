"""The port's two-level cull (yuki_tpu_torch/ops/trace_cull.py) against
yuki_tpu's XLA twin trace_stream.candidate_lists_2l, which
tests/test_cull_fused.py holds bit for bit against the Pallas kernel:
lists and overflow flags bit for bit, on live rays, parked lanes, short
t_max, axis-parallel rays from box corners and forced overflow (small C
and S), and at the edges of the cull's counts and tests (exactly S and
S + 1 words, exactly C and C + 1 chunks, 96 and 97 chunks, signed-zero
directions, zero and negative t_max)."""

from functools import lru_cache

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
SOUP_TRIS = 1100  # 105 chunks: 4 words, the last partial
NC_TRIS = {"nc96": 1059, "nc97": 1056}  # 96 chunks (3 whole words), 97


@lru_cache(maxsize=None)
def _soup(n_tris):
    """A soup of n_tris triangles in 16-triangle chunks."""
    return tp.chunk_soup(n_tris, 29, 16)


@pytest.fixture(scope="module")
def soup():
    return _soup(SOUP_TRIS)


def _rays(soup, seed, shrink=1.0):
    _, _, _, tch = soup
    o, d = tp.divergent_rays(N, seed, tch.treelet_bounds.numpy())
    o[N // 8:] *= shrink  # shrink < 1: rays through the soup's dense core
    rng = np.random.default_rng(seed)
    t_max = np.where(rng.random(N) < 0.2, 0.0,
                     np.where(rng.random(N) < 0.3, 0.8, F32_MAX))
    return o, d, t_max.astype(np.float32)


def _picked(soup, seed, count, values):
    """N rays of a pool of 16 N through the soup, N / len(values) of them
    with each value of ``count(o, d, t_max)`` (a per-ray count)."""
    _, _, _, tch = soup
    o, d = tp.divergent_rays(16 * N, seed, tch.treelet_bounds.numpy())
    o[2 * N:] *= 0.3
    t = np.full(16 * N, F32_MAX, np.float32)
    n = count(*(torch.as_tensor(x) for x in (o, d, t))).numpy()
    idx = []
    for v in values:
        hit = np.nonzero(n == v)[0]
        assert hit.size >= N // len(values), (v, hit.size)
        idx.append(hit[:N // len(values)])
    idx = np.concatenate(idx)
    return o[idx], d[idx], t[idx], n[idx]


def _signed_zero_rays(soup, seed):
    """Directions with one or two components of exactly +0.0 or -0.0,
    origins on chunk-box corners and, along a zero axis, on the box's
    planes: the slab fold's 0 * inf and the sign of the reciprocal."""
    _, _, _, tch = soup
    rng = np.random.default_rng(seed)
    _, d = tp.divergent_rays(N, seed)
    zero = rng.random((N, 3)) < 0.5
    zero[np.arange(N), rng.integers(0, 3, N)] = False
    signed = np.where(rng.random((N, 3)) < 0.5, np.float32(0.0),
                      np.float32(-0.0))
    d = np.where(zero, signed, d).astype(np.float32)
    cb = tch.treelet_bounds.numpy()
    k = rng.integers(0, cb.shape[0], N)
    mid = 0.5 * (cb[k, :3] + cb[k, 3:6])
    face = np.where(rng.random((N, 3)) < 0.5, cb[k, :3], cb[k, 3:6])
    o = np.where(zero, face, mid - 3.0 * d).astype(np.float32)
    o[: N // 4] = cb[k[: N // 4], :3]
    zeros = d == 0.0
    assert (zeros & np.signbit(d)).any() and (zeros & ~np.signbit(d)).any()
    return o, d, np.full(N, F32_MAX, np.float32)


def _case_rays(soup, case, C, S, shrink):
    """(o, d, t_max, expected overflow or None) of one case."""
    _, _, _, tch = soup
    if case in ("random", "nc96", "nc97"):
        return (*_rays(soup, C + S, shrink), None)
    if case == "words":  # exactly S and S + 1 crossed word boxes
        lo, hi, _ = tcu._word_tables(tch)
        o, d, t, n = _picked(soup, 11, lambda o, d, t: ts.box_crossings(
            lo, hi, o, d, t).sum(1), (S, S + 1))
        return o, d, t, n > S
    if case == "chunks":  # exactly C and C + 1 crossed chunks
        o, d, t, n = _picked(soup, 12, lambda o, d, t: (tcu.candidate_lists_2l(
            tch, o, d, t, 128, S)[0] >= 0).sum(1), (C, C + 1))
        return o, d, t, n > C
    if case == "zero-dirs":
        return (*_signed_zero_rays(soup, 13), None)
    assert case == "t_max"  # zero, negative and tiny t_max
    o, d, _ = _rays(soup, 14, 0.3)
    rng = np.random.default_rng(14)
    t = rng.choice(np.array([0.0, -0.0, -1.0, -F32_MAX, 1e-30, 0.5, F32_MAX],
                            np.float32), N)
    return o, d, t, None


CASES = [
    pytest.param("random", 16, 24, 1.0, id="16-24-1.0"),
    pytest.param("random", 8, 6, 1.0, id="8-6-1.0"),
    pytest.param("random", 4, 3, 0.05, id="4-3-0.05"),
    pytest.param("random", 16, 2, 0.05, id="16-2-0.05"),
    pytest.param("words", 64, 2, None, id="S-and-S+1-words"),
    pytest.param("chunks", 4, 24, None, id="C-and-C+1-chunks"),
    pytest.param("nc96", 16, 24, 0.05, id="n_c-96"),
    pytest.param("nc97", 16, 24, 0.05, id="n_c-97"),
    pytest.param("zero-dirs", 16, 24, None, id="signed-zero-directions"),
    pytest.param("t_max", 16, 24, None, id="zero-and-negative-t_max"),
]


@pytest.mark.parametrize("case,C,S,shrink", CASES)
def test_cull_matches_jax(case, C, S, shrink):
    """Random rays, forced overflow (small C and S), and the edges: rays
    crossing exactly S and S + 1 words, exactly C and C + 1 chunks, chunk
    counts of a multiple of 32 and one more, signed-zero directions, and
    zero or negative t_max."""
    soup = _soup(NC_TRIS.get(case, SOUP_TRIS))
    _, jch, _, tch = soup
    if case in NC_TRIS:
        assert tch.n_treelets == {"nc96": 96, "nc97": 97}[case]
    o, d, t_max, want_ov = _case_rays(soup, case, C, S, shrink)
    ref_l, ref_ov = jts.candidate_lists_2l(
        jch, *(jnp.asarray(x) for x in (o, d, t_max)), C, S=S)
    got_l, got_ov = tcu.candidate_lists_fused(
        tch, *(torch.as_tensor(x) for x in (o, d, t_max)), C, S)
    np.testing.assert_array_equal(got_ov.numpy(), np.asarray(ref_ov))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    assert (got_l.numpy()[t_max <= 0.0] == -1).all()
    assert not got_ov.numpy()[t_max <= 0.0].any()
    assert (got_l.numpy() >= 0).any()
    if want_ov is not None:
        np.testing.assert_array_equal(got_ov.numpy(), want_ov)
    elif case == "random":
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
