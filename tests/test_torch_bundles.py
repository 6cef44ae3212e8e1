"""The port's bundle engine (yuki_tpu_torch/ops/trace_bundles.py) on the
CPU, where the slot walks run their plain versions: tests/test_bundles.py's
contracts on its 500-triangle soup (sah, four shapes a leaf, 16-triangle
chunks), built by the port alone.

For bun 2, 4 and 8 the engine's prim, hits, misses and dead lanes equal
the dense sweep's bit for bit, and its occlusion the dense occlusion
sweep's (skip ids included); its t equals the per-ray slot stream's bit
for bit and the dense sweep's within one ulp: the engine and the stream
divide a scaled hit once (t = ts / det), the dense sweep multiplies by a
reciprocal (ROADMAP "How the engines are held").  Also: the layout's
exactness, one chunk a row, overflow flags under a small C, partition
invariance, and ``extract_lists(wc=...)`` against yuki_tpu's (one XLA
call a case).
"""

import numpy as np
import pytest
import torch

from yuki_tpu_torch import transforms as tf
from yuki_tpu_torch.ops import trace_bundles as tb
from yuki_tpu_torch.ops import trace_stream as ts
from yuki_tpu_torch.ops.trace import F32_MAX, any_trace_plain, pack_triangles
from yuki_tpu_torch.scene.data import SceneBuilder
from yuki_tpu_torch.treelets import build_treelets

torch.set_num_threads(2)

BUNS = (2, 4, 8)


@pytest.fixture(scope="module")
def soup():
    rng = np.random.default_rng(11)
    n_tris = 500
    base = (rng.random((n_tris, 1, 3)) - 0.5) * 6
    tri = (base + rng.standard_normal((n_tris, 3, 3)) * 0.25).astype(
        np.float32)
    b = SceneBuilder()
    m = b.add_matte()
    for t in tri:
        b.add_mesh(tf.Transform.identity(), [0, 1, 2], t, material=m)
    sc = b.build(split_method="sah", max_shapes_in_node=4, device="cpu")
    tris = sc.data.tris
    tri_p = np.stack([tris.p0.numpy(), tris.p1.numpy(), tris.p2.numpy()], 1)
    # Every third triangle carries area-light id 0, for the skip ids.
    light = np.where(np.arange(n_tris) % 3 == 0, 0, -1).astype(np.int32)
    ch = build_treelets(sc.bvh_host, tri_p, light, leaf_size=16,
                        super_size=16, device="cpu")
    return sc, ch, torch.as_tensor(light)


def rays(n, seed):
    rng = np.random.default_rng(seed)
    o = ((rng.random((n, 3), np.float32) - 0.5) * 6).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.as_tensor(o), torch.as_tensor(d)


def closest(ch, o, d, t_max, C=64, mult=80, bun=tb.BUN):
    bw = tb.bundle_words(ts.cross_words(ch, o, d, t_max), bun)
    return tb.bundles_closest_w(ch, bw, o, d, t_max, C=C, mult=mult, bun=bun)


def dense(sc, o, d, t_max):
    tris = sc.data.tris
    from yuki_tpu_torch.ops.trace import dense_trace_plain

    return dense_trace_plain(pack_triangles(tris.p0, tris.p1, tris.p2), o, d,
                             t_max)[:2]


def ulps(a, b):
    return (a.view(torch.int32).to(torch.int64)
            - b.view(torch.int32).to(torch.int64)).abs()


@pytest.mark.parametrize("bun", BUNS)
def test_closest_matches_dense(soup, bun):
    """Live and dead lanes (every third t_max 0): prim and hits equal the
    dense sweep's, dead lanes keep t_max and prim -1, t equals the slot
    stream's bit for bit and the dense sweep's within an ulp."""
    sc, ch, _ = soup
    o, d = rays(1024, 1)
    t_max = torch.where(torch.arange(1024) % 3 == 0, 0.0, F32_MAX)
    t_ref, p_ref = dense(sc, o, d, t_max)
    t, p, ov, ok = closest(ch, o, d, t_max, bun=bun)
    assert ok and not ov.any()
    assert p.dtype == torch.int32
    assert torch.equal(p, p_ref)
    assert (p >= 0).sum() > 100 and (p[t_max > 0] < 0).any()
    dead = t_max == 0.0
    assert (p[dead] == -1).all() and (t[dead] == 0.0).all()
    t_s, p_s, _, ok_s = ts.stream_closest_w(
        ch, ts.cross_words(ch, o, d, t_max), o, d, t_max, C=64, mult=80)
    assert ok_s and torch.equal(p_s, p) and torch.equal(t_s, t)
    assert int(ulps(t, t_ref).max()) <= 1
    miss = p == -1
    assert torch.equal(t[miss], t_max[miss])


@pytest.mark.parametrize("bun", BUNS)
def test_any_matches_dense(soup, bun):
    """Occlusion of segments between soup points with skip ids 0 and -2
    equals the dense occlusion sweep's, bit for bit."""
    sc, ch, light = soup
    o, d = rays(1024, 2)
    t_ref, p_ref = dense(sc, o, d, torch.full((1024,), F32_MAX))
    t_max = torch.where(p_ref >= 0, t_ref * 1.5, 2.0).to(torch.float32)
    t_max[::5] = 0.0
    skip = torch.where(torch.arange(1024) % 2 == 0, 0, -2).to(torch.int32)
    tris = sc.data.tris
    want = any_trace_plain(pack_triangles(tris.p0, tris.p1, tris.p2), light,
                           o, d, t_max, skip)
    bw = tb.bundle_words(ts.cross_words(ch, o, d, t_max), bun)
    occ, ov, ok = tb.bundles_any_w(ch, bw, o, d, t_max, skip, C=64, mult=80,
                                   bun=bun)
    assert ok and not ov.any()
    assert torch.equal(occ, want)
    assert 100 < int(occ.sum()) < 900


def test_layout_exact_complete(soup):
    """Every valid bundle-slot maps to a real (bundle, chunk) candidate of
    its row's chunk, and every candidate gets one slot."""
    _, ch, _ = soup
    n, C, bun = 256, 16, tb.BUN
    n_b = n // bun
    o, d = rays(n, 8)
    tm = torch.full((n,), F32_MAX)
    lists, _ = ts.extract_lists(tb.bundle_words(ts.cross_words(ch, o, d, tm)),
                                C)
    spr = ts.LANES // bun
    max_rows = -(-(2 * n_b * C + ch.n_treelets * spr) // spr // 8) * 8
    pos_s, seg, aligned_off, total = ts.slot_layout(
        n_b, ch.n_treelets, lists, C, spr)
    slot_pos, row_chunk, valid = ts.slot_fill(
        n_b, ch.n_treelets, pos_s, seg, aligned_off, C, max_rows, spr)
    assert int(total) <= max_rows * spr
    lists, slot_pos, row_chunk, valid = (x.numpy() for x in (
        lists, slot_pos, row_chunk, valid))
    seen = set()
    for j in range(max_rows):
        for lane in range(spr):
            if valid[j, lane]:
                p = int(slot_pos[j, lane])
                assert lists[p // C, p % C] == row_chunk[j]
                assert p not in seen
                seen.add(p)
    want = {b * C + m for b in range(n_b) for m in range(C)
            if lists[b, m] >= 0}
    assert seen == want


@pytest.mark.parametrize("bun", BUNS)
def test_rows_single_chunk(soup, bun):
    """Rows of 128 // bun bundle-slots each serve one chunk (the slot
    walks' contract), and the stream's lanes carry the bundles' rays."""
    _, ch, _ = soup
    n, C = 512, 32
    n_b = n // bun
    o, d = rays(n, 12)
    tm = torch.full((n,), F32_MAX)
    bw = tb.bundle_words(ts.cross_words(ch, o, d, tm), bun)
    _, slots = tb._bundle_slots(ch, bw, C, 4 * C, None, bun)
    slot_pos, slot_bun, row_chunk, valid = slots
    lists, _ = ts.extract_lists(bw, C)
    spr = 128 // bun
    assert slot_pos.shape == (row_chunk.shape[0], spr)
    for j in range(row_chunk.shape[0]):
        pos = slot_pos[j][valid[j]]
        assert valid[j].any()
        chunks = set(lists.reshape(-1)[pos].tolist())
        assert chunks == {int(row_chunk[j])}
    stream = tb._pack_bundles(o, d, tm, None, slot_bun, valid, bun)
    lane_bun = slot_bun.repeat_interleave(bun, dim=1).reshape(-1)
    lane_ray = lane_bun * bun + torch.arange(bun).repeat(
        stream.shape[0] // bun)
    live = valid.repeat_interleave(bun, dim=1).reshape(-1)
    assert torch.equal(stream[live, :3], o[lane_ray[live]])
    assert (stream[~live, 6] == -1.0).all()
    assert n_b == bw.shape[0]


def test_overflow_under_small_C(soup):
    """With C = 8 (bun 2) some bundles overflow (all their rays
    flagged); the other rays are exact."""
    sc, ch, _ = soup
    o, d = rays(512, 2)
    t_max = torch.full((512,), F32_MAX)
    t_ref, p_ref = dense(sc, o, d, t_max)
    t, p, ov, ok = closest(ch, o, d, t_max, C=8, mult=12, bun=2)
    assert ok and ov.any() and not ov.all()
    assert torch.equal(ov.reshape(-1, 2).all(1), ov.reshape(-1, 2).any(1))
    keep = ~ov
    assert torch.equal(p[keep], p_ref[keep])
    assert int(ulps(t[keep], t_ref[keep]).max()) <= 1


def test_budget_blown_and_misses(soup):
    """A budget below the demand returns ok False; rays that cross nothing
    get t_max and prim -1."""
    _, ch, _ = soup
    o, d = rays(256, 3)
    tm = torch.full((256,), F32_MAX)
    assert not closest(ch, o, d, tm, C=16, mult=0)[3]
    far = torch.tensor([100.0, 100.0, 100.0]).expand(256, 3).contiguous()
    x = torch.tensor([1.0, 0.0, 0.0]).expand(256, 3).contiguous()
    t, p, ov, ok = closest(ch, far, x, tm, C=16, mult=20)
    assert ok and (p == -1).all() and torch.equal(t, tm)


@pytest.mark.parametrize("bun", BUNS)
def test_partition_invariant(soup, bun):
    """Bundle composition changes no per-ray result: the same rays inside
    another wave mixture agree bit for bit."""
    _, ch, _ = soup
    o, d = rays(256, 4)
    t_a, p_a, _, _ = closest(ch, o, d, torch.full((256,), F32_MAX), bun=bun)
    o2, d2 = rays(256, 5)
    t_b, p_b, _, _ = closest(ch, torch.cat([o2, o]), torch.cat([d2, d]),
                             torch.full((512,), F32_MAX), bun=bun)
    assert torch.equal(p_a, p_b[256:]) and torch.equal(t_a, t_b[256:])


@pytest.mark.parametrize("w", (40, 100))
def test_extract_lists_wc_matches_jax(w):
    """extract_lists with wc = 32 against yuki_tpu's on random words: W at
    40 and at 100 (above _auto_wc's 48), rows with few and with more than
    32 nonzero words, lists and overflow bit for bit."""
    import jax.numpy as jnp

    from yuki_tpu.ops.trace_stream import extract_lists as jax_extract

    rng = np.random.default_rng(w)
    words = rng.integers(0, 2 ** 32, (96, w), dtype=np.uint64)
    dens = rng.choice([0.05, 0.2, 0.5, 0.95], size=(96, 1))
    words = np.where(rng.random((96, w)) < dens, words, 0).astype(np.uint32)
    words[:, 0] |= 1
    C = 48
    jl, jo = jax_extract(jnp.asarray(words), C, wc=32)
    tl, to = ts.extract_lists(torch.as_tensor(words.astype(np.int64)), C,
                              wc=32)
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert np.array_equal(to.numpy(), np.asarray(jo))
    nz = (words != 0).sum(1)
    if w > 32:
        assert (nz > 32).any() and (to.numpy()[nz > 32]).all()
    assert (~to.numpy()).any()
    assert tb._auto_wc(w) == (32 if w > 48 else None)
