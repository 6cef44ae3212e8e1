"""The port's slot stream (yuki_tpu_torch/ops/trace_stream.py) against
yuki_tpu's on a random soup cut into 16-triangle chunks.

Integer results are held bit for bit: crossing words against
_cross_words_xla, candidate lists and overflow flags from extract_lists /
extract_compact, the slot layout against build_slots.  The slot walks,
merges and barycentrics are held bit for bit too: yuki_tpu's stream_*_l
run with its Pallas kernels evaluated step by step and op by op
(torch_parity.eager_grid_pallas), because Pallas interpret mode is
compiled by XLA, which contracts a*b + c into FMAs; the port rounds every
product, as its CUDA kernels do (-fmad=false).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from yuki_tpu.ops import trace_stream as jts
from yuki_tpu_torch.ops import trace_cull as tcu
from yuki_tpu_torch.ops import trace_stream as ts
from yuki_tpu_torch.ops.trace import F32_MAX

torch.set_num_threads(2)

N = 512


@pytest.fixture(scope="module")
def soup():
    """900 triangles in 16-triangle chunks (85 chunks, 3 words)."""
    return tp.chunk_soup(900, 23, 16)


def _rays(soup, seed, t=F32_MAX, axis_parallel=True):
    """Divergent rays, an eighth axis-parallel from chunk-box corners, a
    fifth parked (t_max 0)."""
    _, _, _, tch = soup
    o, d = tp.divergent_rays(N, seed, tch.treelet_bounds.numpy()
                             if axis_parallel else None)
    t_max = np.full(N, t, np.float32)
    t_max[np.random.default_rng(seed).random(N) < 0.2] = 0.0
    return o, d, t_max


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.as_tensor(np.asarray(x)) for x in xs]


def test_popcount_matches_python():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2 ** 32, 4096, dtype=np.int64)
    words[:3] = [0, 2 ** 32 - 1, 2 ** 31]
    got = ts.popcount32(torch.as_tensor(words)).numpy()
    np.testing.assert_array_equal(got, [bin(int(w)).count("1") for w in words])


@pytest.mark.parametrize("axis_parallel", [False, True])
def test_cross_words_match_jax(soup, axis_parallel):
    _, jch, _, tch = soup
    o, d, t_max = _rays(soup, 2, axis_parallel=axis_parallel)
    ref = np.asarray(jts._cross_words_xla(jch, *_j(o, d, t_max)))
    got = ts.cross_words(tch, *_t(o, d, t_max)).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    assert got.shape == (N, 3) and (got[t_max == 0.0] == 0).all()
    assert ts.LAUNCHES["cross_words"] == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("C", [4, 16, 64])
def test_extract_lists_match_jax(soup, C):
    _, jch, _, _ = soup
    o, d, t_max = _rays(soup, 3)
    words = jts._cross_words_xla(jch, *_j(o, d, t_max))
    ref_l, ref_ov = jts.extract_lists(words, C)
    got_l, got_ov = ts.extract_lists(torch.as_tensor(
        np.asarray(words).astype(np.int64)), C)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(got_ov.numpy(), np.asarray(ref_ov))
    assert got_ov.any() == (C == 4)


def test_extract_compact_matches_jax(soup):
    _, jch, _, _ = soup
    o, d, t_max = _rays(soup, 4)
    words, base, _ = jts.cross_compact(jch, *_j(o, d, t_max), S=4)
    for C in (3, 16):
        ref_l, ref_ov = jts.extract_compact(words, base, C)
        got_l, got_ov = ts.extract_compact(
            torch.as_tensor(np.asarray(words).astype(np.int64)),
            torch.as_tensor(np.array(base)), C)
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
        np.testing.assert_array_equal(got_ov.numpy(), np.asarray(ref_ov))


def test_slot_layout_matches_jax_exact_and_complete(soup):
    """build_slots equals yuki_tpu's; every valid slot maps to a real
    (ray, chunk) candidate of its row's chunk and every candidate gets
    exactly one slot (tests/test_stream.py:114-141)."""
    _, jch, _, tch = soup
    o, d, t_max = _rays(soup, 5)
    C = 16
    lists, _ = tcu.candidate_lists_2l(tch, *_t(o, d, t_max), C)
    n_c = tch.n_treelets
    max_rows = 2 * N * C // 128 + n_c + 8
    ref = [np.asarray(x) for x in jts.build_slots(
        N, n_c, jnp.asarray(lists.numpy()), C, max_rows)]
    got = ts.build_slots(N, n_c, lists, C, max_rows)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(g), r)
    slot_pos, row_chunk, valid, ok = (np.asarray(x) for x in got)
    assert ok
    lists = lists.numpy()
    seen = set()
    for j, lane in zip(*np.nonzero(valid)):
        p = int(slot_pos[j, lane])
        assert lists[p // C, p % C] == row_chunk[j]
        assert p not in seen
        seen.add(p)
    assert seen == {r * C + m for r, m in zip(*np.nonzero(lists >= 0))}
    # Too small a budget: not ok on both sides.
    assert not bool(jts.build_slots(N, n_c, jnp.asarray(lists), C, 2)[3])
    assert not bool(ts.build_slots(N, n_c, torch.as_tensor(lists), C, 2)[3])


def test_budget_helpers_match_jax():
    for args in ((524288, 16, 1454, 6), (2048, 128, 1454, 128), (7, 4, 3, 0)):
        assert ts._max_rows(*args) == jts._max_rows(*args)
    for m, mw in ((4, 6), (6, 6), ((8, 40), 128), (5, None)):
        assert ts._tier_mults(m, mw) == jts._tier_mults(m, mw)


@pytest.mark.parametrize("C", [16, 4])
def test_stream_closest_l_matches_jax(soup, C):
    """t and prim bit for bit on every ray, overflow rays included (both
    sides walk the same cut lists)."""
    _, jch, _, tch = soup
    o, d, t_max = _rays(soup, 6)
    lists, ov = tcu.candidate_lists_2l(tch, *_t(o, d, t_max), C)
    with tp.eager_grid_pallas():
        ref_t, ref_p, _, ref_ok = jts.stream_closest_l(
            jch, jnp.asarray(lists.numpy()), jnp.asarray(ov.numpy()),
            *_j(o, d, t_max), C=C, mult=8, interpret=True)
    t, prim, got_ov, ok = ts.stream_closest_l(tch, lists, ov,
                                              *_t(o, d, t_max), C=C, mult=8)
    assert bool(ref_ok) and ok
    np.testing.assert_array_equal(prim.numpy(), np.asarray(ref_p))
    np.testing.assert_array_equal(t.numpy(), np.asarray(ref_t))
    assert got_ov is ov and int((prim >= 0).sum()) > N // 8
    assert bool(ov.any()) == (C == 4)


def test_stream_any_l_matches_jax(soup):
    _, jch, _, tch = soup
    o, d, t_max = _rays(soup, 7, t=2.5)
    skip = np.random.default_rng(7).choice([-2, -1, 0], N).astype(np.int32)
    lists, ov = tcu.candidate_lists_2l(tch, *_t(o, d, t_max), 16)
    with tp.eager_grid_pallas():
        ref, _, ref_ok = jts.stream_any_l(
            jch, jnp.asarray(lists.numpy()), jnp.asarray(ov.numpy()),
            *_j(o, d, t_max, skip), C=16, mult=5, interpret=True)
    occ, _, ok = ts.stream_any_l(tch, lists, ov, *_t(o, d, t_max, skip),
                                 C=16, mult=5)
    assert bool(ref_ok) and ok
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref))
    assert occ.any() and not occ[torch.as_tensor(skip) == -1].any()


def test_stream_budget_blown_is_not_ok(soup, monkeypatch):
    """A slot demand above the budget (one row here) gives ok False and
    walks nothing."""
    _, _, _, tch = soup
    o, d, t_max = _rays(soup, 8)
    lists, ov = tcu.candidate_lists_2l(tch, *_t(o, d, t_max), 16)
    monkeypatch.setattr(ts, "_max_rows", lambda *a: 1)
    t, prim, _, ok = ts.stream_closest_l(tch, lists, ov, *_t(o, d, t_max))
    assert not ok and (prim == -1).all()
    _, _, ok = ts.stream_any_l(tch, lists, ov, *_t(o, d, t_max),
                               torch.full((N,), -2, dtype=torch.int32))
    assert not ok


def test_recompute_bary_matches_jax(soup):
    """b0/b1 of the winning triangles, yuki_tpu's run op by op (eager)."""
    jsc, _, tsc, tch = soup
    o, d, t_max = _rays(soup, 9)
    lists, ov = tcu.candidate_lists_2l(tch, *_t(o, d, t_max), 64)
    t, prim, _, _ = ts.stream_closest_l(tch, lists, ov, *_t(o, d, t_max),
                                        C=64, mult=16)
    ref = jts._recompute_bary(jsc.data.tris.shading_packed, *_j(o, d),
                              jnp.asarray(t.numpy()), jnp.asarray(prim.numpy()))
    got = ts._recompute_bary(tsc.data.tris.shading_packed, *_t(o, d), t, prim)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert (got[0][prim < 0] == 0).all() and got[0][prim >= 0].abs().sum() > 0


def test_plain_walks_count_the_tests_of_live_slots(soup):
    """The tallies chip_smoke.py turns into the slot walks' bounds: every
    real triangle of the chunk for each live slot (closest); up to the
    first occluder (occlusion)."""
    _, _, _, tch = soup
    o, d, t_max = _rays(soup, 10, t=2.5)
    lists, _ = tcu.candidate_lists_2l(tch, *_t(o, d, t_max), 16)
    _, slot_ray, row_chunk, valid = ts._slots(tch, lists, 16, 8, None, N)
    stream = ts._pack_stream(*_t(o, d, t_max), slot_ray, valid,
                             extra=torch.full((N,), -2, dtype=torch.int32))
    rows = tch.rows.reshape(-1, 16, 12)
    live = torch.nonzero(stream[:, 6] > 0).squeeze(1)
    chunk = row_chunk.long()[live // 128]
    real = (rows[:, :, 10] >= 0).sum(dim=1)[chunk]
    stats = {}
    ts.slot_closest_plain(tch.rows, 16, row_chunk, stream, stats)
    assert stats["tests"] == int(real.sum())
    stats = {}
    occ = ts.slot_any_plain(tch.rows, 16, row_chunk, stream, stats)
    assert 0 < stats["tests"] < int(real.sum()) and occ.any()
