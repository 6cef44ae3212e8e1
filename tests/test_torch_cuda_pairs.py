"""The block-pair walks (pairs_closest_walk, pairs_any_walk) against their
plain PyTorch versions, on the card, and against the treelet walk.
Marked ``cuda``: they skip where torch.cuda.is_available() is False.  This
file imports no JAX, so on the card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_pairs.py

Kernel and plain version run on the same card and must agree bit for bit.
Against the treelet walk (same direct-t test, other visit order) t must be
equal, prim equal apart from ties (equal t), occlusion equal.
"""

import numpy as np
import pytest
import torch

from test_torch_cuda_stream import _rays, cuda, scenes  # noqa: F401
from test_torch_pairs_redesign import hand_built, packed_tables
from yuki_tpu_torch import traverse
from yuki_tpu_torch.ops import trace_pairs as tpp
from yuki_tpu_torch.ops import trace_treelets as ttt

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)

N = 6000  # five whole blocks and a ragged one


def _sorted_rays(scene, seed, dev):
    o, d, t_max = _rays(scene, N, seed, dev)
    order = torch.argsort(traverse.ray_sort_key(scene.data, o, d),
                          stable=True)
    return o[order].contiguous(), d[order].contiguous(), t_max[order]


@pytest.mark.parametrize("which", ["reduced", "full"])
def test_pair_walks_match_plain(cuda, scenes, which):
    scene = scenes[which]
    tl = scene.data.treelets
    o, d, t_max = _sorted_rays(scene, 21, cuda)
    rng = np.random.default_rng(22)
    skip = torch.as_tensor(rng.choice([-2, -1, 0], N).astype(np.int32),
                           device=cuda)
    chord = torch.where(t_max > 0.0, 3.0, 0.0)
    pb, pt, n_pairs, nb = tpp.block_candidate_pairs(tl, o, d, t_max, 10 ** 6)
    runs = tpp.pair_runs(pb, n_pairs, nb)
    tpp.reset_launches()
    packed = tpp._pack_rays(o, d, t_max, nb)
    got = tpp.pairs_closest_walk(tl, runs, pt, packed, N)
    ref = tpp.pairs_closest_plain(tl, runs, pt, packed)
    for g, r in zip(got, ref):
        assert torch.equal(g, r[:N])
    packed = tpp._pack_rays(o, d, chord, nb, skip)
    occ = tpp.pairs_any_walk(tl, runs, pt, packed, N)
    assert torch.equal(occ, tpp.pairs_any_plain(tl, runs, pt, packed)[:N])
    assert tpp.LAUNCHES == {"pairs_closest": 1, "pairs_any": 1}
    assert bool(occ.any()) and not bool(occ.all())

    # Against the treelet walk, on the rays with no zero direction
    # component: an axis-parallel ray's own slab test is NaN (0 * inf) and
    # fails, so it tests a box's rows only when the block visits them for
    # other lanes, and the two walks visit in other orders and (occlusion)
    # leave a box's rows at other points.
    t_w, p_w = ttt.treelet_closest(tl, o, d, t_max)[:2]
    occ_w = ttt.treelet_any(tl, o, d, chord, skip)
    slanted = (d != 0.0).all(dim=1)
    assert torch.equal(got[0][slanted], t_w[slanted])
    tie = got[1] != p_w
    assert int((tie & slanted).sum()) <= N // 1000
    assert torch.equal(occ[slanted], occ_w[slanted])


def test_pairs_overflow(cuda, scenes):
    """Past max_pairs the walk keeps the first pairs and reports n_pairs."""
    scene = scenes["reduced"]
    tl = scene.data.treelets
    o, d, t_max = _sorted_rays(scene, 23, cuda)
    _, _, _, _, n_pairs = tpp.pairs_closest(tl, o, d, t_max)
    t, prim, _, _, n2 = tpp.pairs_closest(tl, o, d, t_max,
                                          max_pairs=n_pairs // 2)
    assert n2 == n_pairs
    assert t.shape == (N,) and prim.dtype == torch.int32


@pytest.mark.parametrize("k", [16, 64, 256])
def test_walks_match_plain_on_hand_built_blocks(cuda, k):
    """tests/test_torch_pairs_redesign.py's edge blocks (an axis lane
    visited for others, a take closing a later pair of its window, dead
    and NaN lanes, a skip id on the only occluder, lanes blocked before and
    after r*, a ragged block voted by its padding lanes, runs of one pair
    and of two windows); k = 256 takes more than 48 KB of shared memory."""
    hb = hand_built(k, device=cuda)
    tl, runs, pt = hb[:3]
    n = hb[3].shape[0]
    packed, packed_any = packed_tables(hb)
    tpp.reset_launches()
    got = tpp.pairs_closest_walk(tl, runs, pt, packed, n)
    ref = tpp.pairs_closest_plain(tl, runs, pt, packed)
    for g, r in zip(got, ref):
        assert torch.equal(g.view(torch.int32), r[:n].view(torch.int32))
    occ = tpp.pairs_any_walk(tl, runs, pt, packed_any, n)
    assert torch.equal(occ, tpp.pairs_any_plain(tl, runs, pt,
                                                packed_any)[:n])
    assert tpp.LAUNCHES == {"pairs_closest": 1, "pairs_any": 1}
    assert bool(occ.any()) and not bool(occ.all())
