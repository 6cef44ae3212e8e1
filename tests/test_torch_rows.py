"""The row-union engine's plain closest walk (yuki_tpu_torch/ops/
trace_rows.py) against yuki_tpu.ops.trace_rows, bit for bit.

Both sides walk the same union words (the exact crossing words OR-ed per
row, as yuki_tpu's rows_closest makes them) of tests/test_rows.py's soup
(500 triangles, leaf 16) with 1024 camera-like rays (a 32-pixel-wide film
in row order), an eighth of them axis-parallel from chunk-box corners (the
recheck's 0 * inf) and a seventh parked with t_max 0.  yuki_tpu's Pallas
kernel runs step by step and op by op (torch_parity.eager_grid_pallas;
interpret mode would let XLA contract FMAs).  Overflow flags must be equal
everywhere, t and prim on every ray that did not overflow.  Cases: plain;
two rows whose words are emptied, so that they walk only their forced
pair (chunk 0), which finds hits; a list width C below some rows' unions;
several pair-budget segments (SEG_R monkeypatched on both sides, as
tests/test_rows.py's test_multi_segment_parity does) with a budget that
some segments blow.  The occlusion walk is in test_torch_rows_any.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from torch_scenes import row_trap
from yuki_tpu.ops import trace_rows as jrows
from yuki_tpu.ops import trace_stream as jts
from yuki_tpu_torch.ops import trace_rows as trows
from yuki_tpu_torch.ops.trace import F32_MAX

torch.set_num_threads(2)

N = 1024
# case: (C, mult, SEG_R), sized to the rows' unions (18-25 chunks a row)
CASES = {"plain": (48, 24, None), "empty_rows": (48, 24, None),
         "over_c": (20, 20, None), "segments": (48, 20, 2)}


@pytest.fixture(scope="module")
def soup():
    return tp.chunk_soup(500, 11, 16)


def camera_rays(seed, boxes, rows):
    """N rays from (0.3, 0.2, 6) through a 32 x N/32 film over the middle
    of the soup, jittered; every eighth axis-parallel from the lo corner of
    one of four boxes; every 32nd (lane 5 mod 32) at the centroid of a
    triangle of chunk 0 (triangle ``rows`` [k, 12] of the chunk)."""
    rng = np.random.default_rng(seed)
    i = np.arange(N)
    film = np.stack([(i % 32 + rng.random(N)) / 32 - 0.5,
                     (i // 32 + rng.random(N)) / (N // 32) - 0.5,
                     -4.0 * np.ones(N)], 1)
    o = np.tile(np.array([[0.3, 0.2, 6.0]]), (N, 1))
    d = film / np.linalg.norm(film, axis=1, keepdims=True)
    par = i % 8 == 0
    d[par] = 0.0
    d[par, rng.integers(0, 3, par.sum())] = rng.choice([-1.0, 1.0], par.sum())
    o[par] = boxes[rng.integers(0, 4, par.sum()), :3]
    aim = i % 32 == 5
    tri = rows[rows[:, 10] >= 0][:, :9].reshape(-1, 3, 3).mean(axis=1)
    d[aim] = tri[rng.integers(0, tri.shape[0], aim.sum())] - o[aim]
    d[aim] /= np.linalg.norm(d[aim], axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def rows_inputs(soup, case, seed, t_chord=None):
    """(JAX args, port args) of rows_*_w for one case: union words, o, d,
    t_max; with ``t_chord`` the live rays' t_max is that chord."""
    _, jch, _, tch = soup
    o, d = camera_rays(seed, tch.treelet_bounds.numpy(),
                       tch.rows[:tch.leaf_size].numpy())
    t_max = np.full(N, F32_MAX if t_chord is None else t_chord, np.float32)
    t_max[np.arange(N) % 7 == 3] = 0.0
    words = np.asarray(jrows.row_words_of(jts._cross_words_xla(
        jch, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)), N // 128))
    if case == "empty_rows":
        words = words.copy()
        words[[2, 5]] = 0
    jargs = (jnp.asarray(words), jnp.asarray(o), jnp.asarray(d),
             jnp.asarray(t_max))
    targs = (torch.as_tensor(words.astype(np.int64)), torch.as_tensor(o),
             torch.as_tensor(d), torch.as_tensor(t_max))
    return jargs, targs


def with_case(monkeypatch, case, fn):
    """fn(C, mult) with the case's SEG_R set on both packages."""
    C, mult, seg_r = CASES[case]
    with monkeypatch.context() as m:
        if seg_r is not None:
            m.setattr(jrows, "SEG_R", seg_r)
            m.setattr(trows, "SEG_R", seg_r)
        return fn(C, mult)


def assert_overflow_mix(case, ov):
    """Each case exercises what it names."""
    if case in ("plain", "empty_rows"):
        assert not ov.any()
    else:
        assert ov.any() and not ov.all(), case


@pytest.mark.parametrize("case", list(CASES))
def test_rows_closest_matches_jax(soup, case, monkeypatch):
    _, jch, _, tch = soup
    jargs, targs = rows_inputs(soup, case, 1)

    def run(C, mult):
        with tp.eager_grid_pallas():
            ref = jrows.rows_closest_w(jch, *jargs, C=C, mult=mult,
                                       interpret=True)
        return ref, trows.rows_closest_w(tch, *targs, C=C, mult=mult)

    (t_r, p_r, ov_r), (t, p, ov) = with_case(monkeypatch, case, run)
    t_r, p_r, ov_r = (np.asarray(x) for x in (t_r, p_r, ov_r))
    t, p, ov = t.numpy(), p.numpy(), ov.numpy()
    np.testing.assert_array_equal(ov, ov_r)
    assert_overflow_mix(case, ov)
    keep = ~ov
    np.testing.assert_array_equal(p[keep], p_r[keep])
    np.testing.assert_array_equal(t[keep], t_r[keep])
    assert (p[keep] >= 0).sum() > 50
    if case == "empty_rows":
        # The forced pair: rows 2 and 5 walk chunk 0 alone and hit there.
        forced = p.reshape(-1, 128)[[2, 5]]
        assert (forced >= 0).any()
        assert set(forced[forced >= 0].tolist()) <= set(
            tch.rows[:tch.leaf_size, 10].numpy().astype(int).tolist())


def trap_chunk():
    """torch_scenes.row_trap as both packages' chunk structures (the JAX
    one with tris_padded [16, 128]): (jch, tch, words, o, d, t_max)."""
    from types import SimpleNamespace

    rows, bounds, words, o, d, t_max = row_trap()
    padded = np.zeros((rows.shape[0], 128), np.float32)
    padded[:, :12] = rows
    jch = SimpleNamespace(n_treelets=1, leaf_size=rows.shape[0],
                          treelet_bounds=jnp.asarray(bounds),
                          tris_padded=jnp.asarray(padded))
    tch = SimpleNamespace(n_treelets=1, leaf_size=rows.shape[0],
                          treelet_bounds=torch.as_tensor(bounds),
                          rows=torch.as_tensor(rows))
    return jch, tch, words, o, d, t_max


def test_rows_closest_traps():
    """A chunk is walked by every lane of a row once one lane's recheck
    passes: lane A, whose recheck fails (NaN), hits triangle 8 in rows 0
    and 2 but not alone in row 1; equal to yuki_tpu's kernel."""
    jch, tch, words, o, d, t_max = trap_chunk()
    with tp.eager_grid_pallas():
        ref = jrows.rows_closest_w(jch, *(jnp.asarray(x) for x in
                                          (words, o, d, t_max)),
                                   C=4, mult=4, interpret=True)
    t, p, ov = trows.rows_closest_w(
        tch, torch.as_tensor(words.astype(np.int64)), *(
            torch.as_tensor(x) for x in (o, d, t_max)), C=4, mult=4)
    for g, r in zip((t, p, ov), ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert p[[0, 1, 128, 256, 257]].tolist() == [1, 0, -1, 1, 1]


def test_kept_lists_budget():
    """kept_lists drops the pairs past a segment's cap, in row order with
    each row's count rounded up to QUAD, and flags the whole segment."""
    words = torch.zeros((4, 1), dtype=torch.int64)
    words[0, 0] = 0b111  # 3 chunks -> 4 pair slots
    words[1, 0] = 0b11111  # 5 chunks -> 8 slots
    words[3, 0] = 1 << 9  # row 2 empty -> forced chunk 0
    lists, ov = trows.kept_lists(words, C=8, mult=2)  # cap 8 of one segment
    assert lists[0, :3].tolist() == [0, 1, 2] and lists[0, 3] == -1
    assert lists[1, :4].tolist() == [0, 1, 2, 3] and lists[1, 4] == -1
    assert (lists[2:] == -1).all() and ov.all()
    lists, ov = trows.kept_lists(words, C=4, mult=8)
    assert ov.tolist() == [False, True, False, False]
    assert lists[2, 0] == 0 and lists[3, 0] == 9
