"""The port's leftovers against yuki_tpu and against each other, on the
CPU: ``trace_rows.row_words_of`` / ``row_candidate_lists`` and the
stand-alone row queries, ``build_treelets(pack_chunks=True)``,
``BvhHost.node_bounds`` and the numpy BVH builder.

The numpy builder is held against the native builder, field for field,
for the three split methods on Cornell and on a 500-triangle soup: it
computes as the C++ does and reorders as libstdc++'s partition and
introselect do.  yuki_tpu's own numpy builder is not the reference here:
its trees differ from the native ones where centroids tie.
"""

import numpy as np
import pytest
import torch

import torch_parity as tp
from yuki_tpu_torch.bvh import build_bvh
from yuki_tpu_torch.ops import trace_rows as tr
from yuki_tpu_torch.ops import trace_stream as ts
from yuki_tpu_torch.ops.trace import F32_MAX
from yuki_tpu_torch.treelets import build_treelets

torch.set_num_threads(2)

BVH_FIELDS = ("node_lo", "node_hi", "prim_offset", "prim_count", "child0",
              "child1", "axis", "depth", "links", "prim_order")


@pytest.fixture(scope="module")
def soup():
    """(JAX scene, JAX chunks, port scene, port chunks): the 500-triangle
    soup's 16-triangle chunk cut, built by either package."""
    return tp.chunk_soup(500, 11, 16)


def tri_of(scene):
    t = scene.data.tris
    return np.stack([np.asarray(t.p0), np.asarray(t.p1), np.asarray(t.p2)], 1)


def rows_rays(n, seed):
    """Camera-like rows: 128-ray rows from one origin each, fanning over a
    small cone, some parked (t_max 0)."""
    rng = np.random.default_rng(seed)
    rows = n // 128
    o = np.repeat((rng.random((rows, 3)) - 0.5) * 6, 128, axis=0)
    aim = np.repeat(rng.standard_normal((rows, 3)), 128, axis=0)
    d = aim + rng.standard_normal((n, 3)) * 0.1
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rng.random(n) < 0.1, 0.0, F32_MAX)
    return [np.asarray(x, np.float32) for x in (o, d, t_max)]


def test_row_words_and_lists_match_jax(soup):
    """row_words_of and row_candidate_lists bit for bit against yuki_tpu's
    on 512 rays (4 rows); the union words hold each ray's own."""
    import jax.numpy as jnp

    from yuki_tpu.ops import trace_rows as jtr
    from yuki_tpu.ops import trace_stream as jts

    _, jch, _, tch = soup
    o, d, t = rows_rays(512, 3)
    jo, jd, jt = (jnp.asarray(x) for x in (o, d, t))
    to, td, tt = (torch.as_tensor(x) for x in (o, d, t))
    words = ts.cross_words(tch, to, td, tt)
    rw = tr.row_words_of(words, 4)
    assert np.array_equal(
        rw.numpy().astype(np.uint32),
        np.asarray(jtr.row_words_of(jts.cross_words(jch, jo, jd, jt), 4)))
    assert torch.equal(rw.repeat_interleave(128, dim=0) & words, words)
    for C in (8, 64):
        jl, jov = jtr.row_candidate_lists(jch, jo, jd, jt, C)
        tl, tov = tr.row_candidate_lists(tch, to, td, tt, C)
        assert np.array_equal(tl.numpy(), np.asarray(jl))
        assert np.array_equal(tov.numpy(), np.asarray(jov))
    assert tov.numpy().sum() < 4 and jov.shape == (4,)


def test_standalone_rows_queries(soup):
    """rows_closest / rows_any equal rows_closest_w / rows_any_w over the
    exact union words bit for bit, and the dense sweep's prim and
    occlusion where not flagged overflow."""
    jsc, _, tsc, tch = soup
    o, d, t = (torch.as_tensor(x) for x in rows_rays(512, 4))
    rw = tr.row_words_of(ts.cross_words(tch, o, d, t), 4)
    got = tr.rows_closest(tch, o, d, t)
    want = tr.rows_closest_w(tch, rw, o, d, t, C=tr.C_ROW, mult=16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    from yuki_tpu_torch import traverse

    _, p_ref, _, _ = traverse.intersect_dense(tsc.data, o, d, t)
    keep = ~got[2]
    assert keep.sum() > 256 and torch.equal(got[1][keep], p_ref[keep])
    skip = torch.full((512,), -2, dtype=torch.int32)
    t_s = torch.where(p_ref >= 0, got[0] * 0.5, 1.0).to(torch.float32)
    occ = tr.rows_any(tch, o, d, t_s, skip, C=16, mult=8)
    occ_w = tr.rows_any_w(tch, tr.row_words_of(ts.cross_words(
        tch, o, d, t_s), 4), o, d, t_s, skip, C=16, mult=8)
    assert torch.equal(occ[0], occ_w[0]) and torch.equal(occ[1], occ_w[1])
    occ_ref = traverse.any_intersect_dense(tsc.data, o, d, t_s, skip)
    keep = ~occ[1]
    assert keep.any() and torch.equal(occ[0][keep], occ_ref[keep])


@pytest.mark.parametrize("leaf", (8, 32, 48))
def test_pack_chunks_matches_jax(soup, leaf):
    """build_treelets(pack_chunks=True) against yuki_tpu's: every table;
    at these leaf sizes some cut subtrees merge, so there are fewer chunks
    than in the plain cut."""
    from yuki_tpu.treelets import build_treelets as jax_build

    jsc, _, tsc, _ = soup
    tri = tri_of(jsc)
    light = np.asarray(jsc.data.tris.area_light)
    j = jax_build(jsc.bvh_host, tri, light, leaf_size=leaf, super_size=leaf,
                  pack_chunks=True)
    t = build_treelets(tsc.bvh_host, tri, light, leaf_size=leaf,
                       super_size=leaf, pack_chunks=True, device="cpu")
    for f in ("super_bounds", "super_range", "treelet_bounds"):
        assert np.array_equal(getattr(t, f).numpy(),
                              np.asarray(getattr(j, f))), f
    assert np.array_equal(t.rows.numpy(), np.asarray(j.tris_padded)[:, :12])
    for f in ("leaf_size", "n_supers", "n_treelets", "ts_max"):
        assert getattr(t, f) == getattr(j, f), f
    plain = build_treelets(tsc.bvh_host, tri, light, leaf_size=leaf,
                           super_size=leaf, device="cpu")
    assert t.n_treelets < plain.n_treelets and t.ts_max == 1
    with pytest.raises(ValueError, match="chunk mode"):
        build_treelets(tsc.bvh_host, tri, light, leaf_size=leaf,
                       super_size=2 * leaf, pack_chunks=True, device="cpu")


def test_node_bounds_match_jax(soup):
    """BvhHost.node_bounds at every level against yuki_tpu's, on the
    soup's tree and on Cornell's."""
    from yuki_tpu.scene.cornell import cornell as jax_cornell
    from yuki_tpu_torch.scene.cornell import cornell

    jsc, _, tsc, _ = soup
    pairs = [(jsc.bvh_host, tsc.bvh_host),
             (jax_cornell()[0].bvh_host, cornell(device="cpu")[0].bvh_host)]
    for jb, tb in pairs:
        for level in range(int(tb.depth.max()) + 2):
            jlo, jhi = jb.node_bounds(level)
            tlo, thi = tb.node_bounds(level)
            assert np.array_equal(tlo, jlo) and np.array_equal(thi, jhi)
        lo, hi = tb.node_bounds(0)
        assert lo.shape == (1, 3) and np.array_equal(lo[0], tb.node_lo[0])
        deep = tb.node_bounds(int(tb.depth.max()) + 1)[0]
        assert deep.shape[0] == int((tb.prim_count > 0).sum())


@pytest.mark.parametrize("split", ("sah", "middle", "equal_counts"))
@pytest.mark.parametrize("scene", ("cornell", "soup"))
def test_numpy_builder_equals_native(soup, scene, split):
    """build_bvh(use_native=False) field for field against the native
    builder, with one and with four shapes a leaf."""
    from yuki_tpu_torch.scene.cornell import cornell

    tri = (tri_of(cornell(device="cpu")[0]) if scene == "cornell"
           else tri_of(soup[2]))
    for shapes in (1, 4):
        a = build_bvh(tri, split, shapes)
        b = build_bvh(tri, split, shapes, use_native=False)
        for f in BVH_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert x.tobytes() == y.tobytes(), f
        assert a.max_leaf == b.max_leaf
    with pytest.raises(ValueError, match="split method"):
        build_bvh(tri, "median", use_native=False)
