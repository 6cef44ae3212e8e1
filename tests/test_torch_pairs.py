"""The port's block-pair walks (yuki_tpu_torch/ops/trace_pairs.py) against
yuki_tpu.ops.trace_pairs.

- ``block_candidate_pairs``: n_pairs, n_blocks and each block's set of
  treelets equal; padding entries point at block n_blocks, treelet 0; the
  port's order is block-major, front to back by t_enter, ties by treelet
  id (yuki_tpu's lax.sort leaves ties in no stated order).
- The plain walks against yuki_tpu's ``pairs_closest`` / ``pairs_any``
  given the port's pair list (yuki_tpu's cull monkeypatched to return it),
  bit for bit: t, prim, b0, b1, occlusion.  yuki_tpu's kernels run step by
  step and op by op (torch_parity.eager_grid_pallas under
  jax.disable_jit): Pallas interpret mode is compiled by XLA, which
  contracts a*b + c into FMAs, where the port rounds every product as its
  CUDA kernels do.
- Chunking (tests/test_pairs.py TestChunking): in
  test_torch_pairs_chunks.py, one file each to stay under a minute.
- Overflow: past max_pairs both walk the same first pairs, give the same
  bits and report the same n_pairs.

Inputs: a soup like tests/test_pairs.py's (300 triangles, leaf 16) and 2000
rays: a block of camera-like rays (the cull drops most treelets) and a
ragged block of divergent ones, axis-parallel rays among them (the
slab's 0 * inf), a seventh parked with t_max 0; occlusion with a chord
of 2.5 and skip ids -2, -1 and 0.
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from yuki_tpu.ops import trace_pairs as jtp
from yuki_tpu_torch.ops import trace_pairs as tpp
from yuki_tpu_torch.ops.trace import F32_MAX

torch.set_num_threads(2)

N = 2000


@pytest.fixture(scope="module")
def soup():
    _, jtl, _, ttl = tp.chunk_soup(300, 11, 16)
    return jtl, ttl


def _rays(ttl, seed):
    """Block 0: camera-like rays from (-0.5, 0.5, 6) in a cone toward -z,
    +x and -y (an octant: the cull drops the treelets outside it); block 1
    (976 rays, the rest padding): divergent rays, an eighth axis-parallel
    from treelet-box corners.  A seventh parked with t_max 0."""
    rng = np.random.default_rng(seed)
    m = 1024
    o = np.empty((N, 3), np.float32)
    d = np.empty((N, 3), np.float32)
    o[:m] = [-0.5, 0.5, 6.0]
    d[:m] = np.stack([rng.uniform(0.02, 0.3, m), rng.uniform(-0.3, -0.02, m),
                      -np.ones(m)], 1)
    d[:m] /= np.linalg.norm(d[:m], axis=1, keepdims=True)
    o[m:], d[m:] = tp.divergent_rays(N - m, seed, ttl.treelet_bounds.numpy())
    t_max = np.full(N, F32_MAX, np.float32)
    t_max[np.arange(N) % 7 == 3] = 0.0
    skip = rng.choice([-2, -1, 0], N).astype(np.int32)
    return o, d, t_max, skip


def _t(*xs):
    return [torch.as_tensor(np.array(x)) for x in xs]


def _block_sets(pb, pt, n):
    pb, pt = np.asarray(pb)[:n], np.asarray(pt)[:n]
    return [sorted(pt[pb == b].tolist()) for b in range(int(pb.max()) + 1)]


def test_candidate_pairs_match_jax(soup):
    jtl, ttl = soup
    o, d, t_max, _ = _rays(ttl, 1)
    ref = jtp.block_candidate_pairs(jtl, *(jnp.asarray(x) for x in
                                           (o, d, t_max)), 4096)
    got = tpp.block_candidate_pairs(ttl, *_t(o, d, t_max), 4096)
    n = int(ref[2])
    assert got[2] == n and got[3] == ref[3] == 2
    assert _block_sets(got[0], got[1], n) == _block_sets(ref[0], ref[1], n)
    pb, pt = got[0].numpy(), got[1].numpy()
    assert (pb[n:] == 2).all() and (pt[n:] == 0).all()
    assert (np.diff(pb[:n]) >= 0).all()
    for b in range(2):
        ts_ = pt[:n][pb[:n] == b]
        assert len(set(ts_.tolist())) == len(ts_) and 0 in ts_
    assert n < 2 * ttl.n_treelets  # the cull drops some treelets


@contextlib.contextmanager
def jax_given_pairs(ttl, max_pairs):
    """yuki_tpu's pair walks, op by op, over the port's pair list."""
    def cull(tl, o, d, t_max, mp):
        pb, pt, n_pairs, nb = tpp.block_candidate_pairs(
            ttl, *_t(o, d, t_max), mp)
        return (jnp.asarray(pb.numpy()), jnp.asarray(pt.numpy()),
                jnp.int32(n_pairs), nb)

    saved = jtp.block_candidate_pairs
    jtp.block_candidate_pairs = cull
    try:
        with jax.disable_jit(), tp.eager_grid_pallas():
            yield
    finally:
        jtp.block_candidate_pairs = saved


def _both(soup, seed, max_pairs=None, chunk=None, monkeypatch=None):
    jtl, ttl = soup
    o, d, t_max, skip = _rays(ttl, seed)
    chord = np.where(t_max > 0, 2.5, 0.0).astype(np.float32)
    if max_pairs is None:
        max_pairs = tpp.block_candidate_pairs(ttl, *_t(o, d, t_max), 1)[2]
    if chunk is not None:
        monkeypatch.setattr(jtp, "CHUNK", chunk)
    with jax_given_pairs(ttl, max_pairs):
        ref_c = jtp.pairs_closest(jtl, *(jnp.asarray(x) for x in
                                         (o, d, t_max)), max_pairs=max_pairs)
        ref_a = jtp.pairs_any(jtl, *(jnp.asarray(x) for x in
                                     (o, d, chord, skip)),
                              max_pairs=max_pairs)
    got_c = tpp.pairs_closest(ttl, *_t(o, d, t_max), max_pairs=max_pairs)
    got_a = tpp.pairs_any(ttl, *_t(o, d, chord, skip), max_pairs=max_pairs)
    return ref_c, got_c, ref_a, got_a


def _assert_walks_equal(ref_c, got_c, ref_a, got_a):
    for r, g, name in zip(ref_c[:4], got_c[:4], ("t", "prim", "b0", "b1")):
        r, g = np.asarray(r), g.numpy()
        if r.dtype == np.float32:
            r, g = r.view(np.uint32), g.view(np.uint32)
        np.testing.assert_array_equal(g, r, err_msg=name)
    np.testing.assert_array_equal(got_a[0].numpy(), np.asarray(ref_a[0]))
    assert got_c[4] == int(ref_c[4]) and got_a[1] == int(ref_a[1])


def test_pair_walks_match_jax(soup):
    ref_c, got_c, ref_a, got_a = _both(soup, 2)
    _assert_walks_equal(ref_c, got_c, ref_a, got_a)
    prim, occ = got_c[1].numpy(), got_a[0].numpy()
    assert (prim >= 0).sum() > N // 10 and (prim < 0).any()
    assert occ.any() and not occ.all()


def test_overflow_reports_n_pairs(soup):
    """max_pairs below the demand: the first max_pairs pairs are walked on
    both sides, and n_pairs tells the caller to fall back."""
    jtl, ttl = soup
    o, d, t_max, _ = _rays(ttl, 4)
    n_pairs = tpp.block_candidate_pairs(ttl, *_t(o, d, t_max), 1)[2]
    ref_c, got_c, ref_a, got_a = _both(soup, 4, max_pairs=n_pairs // 2)
    assert got_c[4] == n_pairs > n_pairs // 2
    _assert_walks_equal(ref_c, got_c, ref_a, got_a)
    full = tpp.pairs_closest(ttl, *_t(o, d, t_max), max_pairs=n_pairs)
    assert not torch.equal(full[1], got_c[1])  # the cut list misses hits
