"""The port's bundle walker (yuki_tpu_torch/ops/trace_walker.py) against
yuki_tpu's walker_closest_w (its occlusion walk: test_torch_walker_any.py;
yuki_tpu's walker runs op by op, and each file compiles its eager ops once,
~30 s).

yuki_tpu's walker kernels run step by step and op by op
(torch_parity.eager_grid_pallas): Pallas interpret mode is compiled by
XLA, which contracts a*b + c into FMAs, and the port rounds every product
as its CUDA kernels do.  So t, prim, overflow, ok and occlusion are held
bit for bit, on a soup cut into 16-triangle chunks (walker_rays): a demand
past the tight budget tier that fits the wide one, lists cut at a small C
(overflow), a blown budget (only ok and overflow: the walk does not run),
and a hand-made chunk pair whose equal hits tie across slots and across
chunks.
"""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from yuki_tpu.ops import trace_stream as jts
from yuki_tpu.ops import trace_walker as jtw
from yuki_tpu_torch.ops import trace_walker as tw
from yuki_tpu_torch.ops.trace import F32_MAX
from yuki_tpu_torch.ops.trace_bundles import bundle_words

torch.set_num_threads(2)

N = 128
N_TRIS = 900


@pytest.fixture(scope="module")
def soup():
    """900 triangles in 16-triangle chunks (85 chunks, 3 words); area-light
    ids -1, 0 and 1 in the chunk rows for the skip light."""
    light = np.random.default_rng(5).integers(-1, 2, N_TRIS).astype(np.int32)
    return tp.chunk_soup(N_TRIS, 23, 16, light=light)


def walker_rays(soup, seed, t):
    """Divergent rays (an eighth axis-parallel from chunk-box corners),
    every other one aimed at a triangle's centroid, a fifth parked with
    t_max 0, the rest with t_max ``t``."""
    _, _, _, tch = soup
    o, d = tp.divergent_rays(N, seed, tch.treelet_bounds.numpy())
    rng = np.random.default_rng(seed)
    rows = tch.rows.numpy()
    cent = rows[rows[:, 10] >= 0, :9].reshape(-1, 3, 3).mean(axis=1)
    aim = cent[rng.integers(0, cent.shape[0], N // 2)] - o[1::2]
    d[1::2] = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    t_max = np.full(N, t, np.float32)
    t_max[rng.random(N) < 0.2] = 0.0
    return o, d, t_max


def _words(jch, o, d, t_max):
    """(JAX words, port words) of the same rays, which must be equal."""
    jw = jts._cross_words_xla(jch, *(jnp.asarray(x) for x in (o, d, t_max)))
    tw_ = torch.as_tensor(np.asarray(jw).astype(np.int64))
    return jw, tw_


def test_bundle_words_or_the_rays():
    w = torch.as_tensor(np.random.default_rng(2).integers(
        0, 2 ** 32, (64, 3), dtype=np.int64))
    got = bundle_words(w)
    ref = np.bitwise_or.reduce(w.numpy().reshape(8, 8, 3), axis=1)
    np.testing.assert_array_equal(got.numpy(), ref)


def closest_both(jch, tch, o, d, t_max, **kw):
    jw, tw_ = _words(jch, o, d, t_max)
    with tp.eager_grid_pallas():
        ref = jtw.walker_closest_w(jch, jw, *(jnp.asarray(x) for x in
                                              (o, d, t_max)),
                                   interpret=True, **kw)
    got = tw.walker_closest_w(tch, tw_, *(torch.as_tensor(x) for x in
                                          (o, d, t_max)), **kw)
    return [np.asarray(x) for x in ref], [
        x.numpy() if isinstance(x, torch.Tensor) else x for x in got]


@pytest.mark.parametrize("case", ["two tiers", "overflow", "blown"])
def test_walker_closest_matches_jax(soup, case):
    """"two tiers": the demand (540 pair slots) passes the tight tier (384)
    and fits the wide one (768), as traverse.WALKER_MULT sizes them."""
    _, jch, _, tch = soup
    kw = {"two tiers": dict(C=64, mult=24, mult_wide=48),
          "overflow": dict(C=4, mult=8),
          "blown": dict(C=64, mult=1)}[case]
    ref, got = closest_both(jch, tch, *walker_rays(soup, 3, F32_MAX), **kw)
    assert bool(ref[3]) == got[3] == (case != "blown")
    np.testing.assert_array_equal(got[2], ref[2])  # overflow
    assert got[2].any() == (case == "overflow")
    if case == "blown":
        return
    np.testing.assert_array_equal(got[0].view(np.uint32),
                                  ref[0].view(np.uint32))
    np.testing.assert_array_equal(got[1], ref[1])
    if case == "two tiers":
        assert (got[1] >= 0).sum() > N // 3
    assert tw.LAUNCHES["walker_closest"] == 0  # CPU tensors: plain version


def tie_chunks():
    """Two hand-made 8-triangle chunks under the same box [0, 1]^3 and one
    bundle of rays along +z through (0.3..0.6, 0.3), the other bundles
    parked (the same wave shape as the soup's tests, so that yuki_tpu's
    eager ops are compiled once).  One triangle at
    z = 0.5 sits in chunk 0 slot 1 (prim 5), chunk 0 slot 3 (prim 2) and
    chunk 1 slot 1 (prim 1); the other rows are padding.  All three give
    each ray the same scaled hit.  Slot 1 keeps the first in list order
    (prim 5, not 1), and the fold takes the lower prim of slots 1 and 3:
    prim 2, where a running minimum with lowest-prim ties would give 1."""
    k = 8
    rows = np.zeros((2 * k, 12), np.float32)
    rows[:, 9:11] = -1.0
    tri = [0.0, 0.0, 0.5, 1.0, 0.0, 0.5, 0.0, 1.0, 0.5]
    for row, prim in ((1, 5), (3, 2), (k + 1, 1)):
        rows[row, :9] = tri
        rows[row, 10] = prim
    bounds = np.tile(np.array([[0, 0, 0, 1, 1, 1, 0, 0]], np.float32), (2, 1))
    o = np.zeros((N, 3), np.float32)
    o[:8] = np.stack([0.3 + 0.04 * np.arange(8), np.full(8, 0.3),
                      np.full(8, -1.0)], 1)
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (N, 1))
    t_max = np.zeros(N, np.float32)
    t_max[:8] = F32_MAX
    padded = np.zeros((2 * k, 128), np.float32)
    padded[:, :12] = rows
    jch = SimpleNamespace(n_treelets=2, leaf_size=k,
                          treelet_bounds=jnp.asarray(bounds),
                          tris_padded=jnp.asarray(padded))
    tch = SimpleNamespace(n_treelets=2, leaf_size=k,
                          treelet_bounds=torch.as_tensor(bounds),
                          rows=torch.as_tensor(rows))
    return jch, tch, o, d, t_max


def test_walker_ties_across_slots_and_chunks():
    jch, tch, o, d, t_max = tie_chunks()
    ref, got = closest_both(jch, tch, o, d, t_max, C=64, mult=24,
                            mult_wide=48)
    assert got[3] and bool(ref[3])
    np.testing.assert_array_equal(got[0].view(np.uint32),
                                  ref[0].view(np.uint32))
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[1].tolist() == [2] * 8 + [-1] * (N - 8)
    np.testing.assert_allclose(got[0][:8], 1.5, rtol=1e-6)


def test_budget_counts_segments(monkeypatch):
    """A segment's demand counts each bundle's list rounded up to QUAD, an
    empty list as one quad, pad bundles of the last segment included; ok
    against the widest tier's cap."""
    lists = torch.full((5, 8), -1, dtype=torch.int32)
    lists[0, :5] = torch.arange(5)  # 8 pair slots
    lists[1, :2] = torch.arange(2)  # 4
    monkeypatch.setattr(tw, "SEG_B", 2)  # 3 segments: 12, 8, 4 + 4 (pad)
    assert tw._mult_cap(2, 5) == 16 and tw._mult_cap(2, 3) == 8
    assert bool(tw.budget_ok(lists, 5))
    assert not bool(tw.budget_ok(lists, 3))
    assert bool(tw.budget_ok(lists, 3, mult_wide=6))
    assert not bool(tw.budget_ok(lists, 3, mult_wide=2))
