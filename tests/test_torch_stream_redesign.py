"""The contracts the redesigned crossing-words and closest slot-walk
kernels (yuki_tpu_torch/ops/csrc/trace_stream.cu) rest on, held on the
plain versions they are compared with on the card.

- Padding rows never win: a chunk's padding rows (prim id -1, light -3)
  can be given any geometry, even a closed tetrahedron around every ray's
  origin, and the slot walks' results keep their bits.  So the closest
  walk may stop at its chunk's last real row, and the occlusion walk too,
  where it stops (not rounded to 8).
- Crossing words are per ray: a wave's words are the concatenation of its
  slices' and follow a permutation of its rays, so a kernel may give each
  ray a warp and take the rays in any order.  Dead rays, axis-parallel
  directions (0 and -0.0), t_max = +inf and a chunk count that is not a
  multiple of 32 are held against yuki_tpu's _cross_words_xla.
- The kernel's tables, cached on the chunk structure, are word_boxes(...,
  inf) and the +inf-padded chunk boxes, equal to the tables yuki_tpu's
  Pallas kernel is handed.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_scenes import REDUCED
from yuki_tpu.ops import trace_stream as jts
from yuki_tpu_torch.ops import trace_cull as tcu
from yuki_tpu_torch.ops import trace_stream as ts
from yuki_tpu_torch.ops.trace import F32_MAX, ray_shear, watertight_scaled
from yuki_tpu_torch.scene.testscenes import colonnade

torch.set_num_threads(2)

N = 512


@pytest.fixture(scope="module")
def soup():
    """900 triangles in 16-triangle chunks (85 chunks, 3 words)."""
    return tp.chunk_soup(900, 23, 16)


@pytest.fixture(scope="module")
def col():
    """The reduced colonnade's chunks (128-triangle rows) and box."""
    scene = colonnade(device="cpu", **REDUCED)[0]
    return (scene.data.chunks, scene.data.world_lo.numpy(),
            scene.data.world_hi.numpy())


def _scene(name, soup, col):
    """(chunks, rays o, d) of a scene: the soup's divergent rays, or rays
    from the colonnade's box at random directions."""
    if name == "soup":
        tch = soup[3]
        o, d = tp.divergent_rays(N, 11, tch.treelet_bounds.numpy())
        return tch, o, d
    ch, lo, hi = col
    rng = np.random.default_rng(12)
    o = (lo + rng.random((N, 3)) * (hi - lo)).astype(np.float32)
    d = rng.standard_normal((N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return ch, o, d


def _tetrahedron(points):
    """The 4 faces [4, 9] of a regular tetrahedron whose inscribed sphere
    holds every point: a closed mesh around them, so the watertight test
    finds a face on every ray from any of them.  Returns (faces, the
    largest distance from a point to a face)."""
    c = 0.5 * (points.min(axis=0) + points.max(axis=0))
    r = 1.05 * float(np.linalg.norm(points - c, axis=1).max())
    v = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                 np.float64) * r * np.sqrt(3.0) + c
    faces = np.stack([v[[0, 1, 2]], v[[0, 1, 3]], v[[0, 2, 3]],
                      v[[1, 2, 3]]]).reshape(4, 9).astype(np.float32)
    return faces, 6.0 * r


def _with_padding(rows, k, faces, pid=None):
    """``rows`` with padding row j of each chunk given face j % 4; with
    ``pid``, the padding rows also take prim ids from pid on (unmasked)."""
    out = rows.clone()
    pad = torch.nonzero(rows[:, 10] < 0.0).squeeze(1)
    f = torch.as_tensor(faces)[(pad % k) % 4]
    out[pad, 0:9] = f
    if pid is not None:
        out[pad, 10] = pid + torch.arange(pad.numel(), dtype=torch.float32)
    return out


def _any_to_last_real(rows, k, row_chunk, stream):
    """The occlusion walk as the kernel walks it: each chunk's rows only
    up to its last real row (prim id >= 0, not rounded up), with
    slot_any_plain's test and hit predicate.  [slots] i32."""
    tri = rows.reshape(-1, k, rows.shape[1])
    last = torch.where(tri[:, :, 10] >= 0.0, torch.arange(1, k + 1),
                       0).amax(dim=1)
    lanes = torch.nonzero(stream[:, 6] > 0.0).squeeze(1)
    ray = stream[lanes]
    chunk = row_chunk.long()[lanes // ts.LANES]
    ox, oy, oz, dx, dy, dz, t0, skip = (ray[:, j] for j in range(8))
    pre = ray_shear(dx, dy, dz)
    occ = torch.zeros_like(t0, dtype=torch.bool)
    for r in range(int(last.max())):
        c = tri[chunk, r]
        ok, ts_, det = watertight_scaled(pre, ox, oy, oz,
                                         [c[:, j] for j in range(9)])
        occ |= ((r < last[chunk]) & ok & (ts_ <= t0 * det)
                & (c[:, 9] != skip) & (c[:, 10] >= 0.0))
    out = torch.zeros(stream.shape[0], dtype=torch.int32)
    out[lanes] = occ.to(torch.int32)
    return out


@pytest.mark.parametrize("walk", ["closest", "closest_skip", "any"])
@pytest.mark.parametrize("scene", ["soup", "colonnade"])
def test_padding_rows_never_win(soup, col, scene, walk):
    """The padding rows' geometry replaced by the faces of a tetrahedron
    around every origin and every triangle, each hit in front of the
    slot's t: the walks give the bits they give on the original rows, and
    the occlusion walk cut at each chunk's last real row gives them on
    both.  The same faces with prim ids (unmasked) do change most live
    slots."""
    ch, o, d = _scene(scene, soup, col)
    k = ch.leaf_size
    rows = ch.rows
    pts = np.concatenate([o, rows[rows[:, 10] >= 0.0][:, 0:9].reshape(
        -1, 3).numpy()])
    faces, reach = _tetrahedron(pts)
    rng = np.random.default_rng(13)
    t_max = np.full(N, F32_MAX if walk != "any" else reach, np.float32)
    t_max[rng.random(N) < 0.1] = 0.0
    skip = rng.choice([-2, -1, 0], N).astype(np.int32)
    o_t, d_t, t_t = (torch.as_tensor(x) for x in (o, d, t_max))
    lists, _ = tcu.candidate_lists_2l(ch, o_t, d_t, t_t, 16)
    _, slot_ray, row_chunk, valid = ts._slots(ch, lists, 16, 8, None, N)
    stream = ts._pack_stream(o_t, d_t, t_t, slot_ray, valid,
                             extra=torch.as_tensor(skip))
    if walk == "any":
        def run(r):
            return ts.slot_any_plain(r, k, row_chunk, stream)
    else:
        def run(r):
            return ts.slot_closest_plain(r, k, row_chunk, stream,
                                         with_skip=walk == "closest_skip")
    ref = run(rows)
    got = run(_with_padding(rows, k, faces))
    assert torch.equal(got, ref)
    if walk == "any":
        for r in (rows, _with_padding(rows, k, faces)):
            assert torch.equal(_any_to_last_real(r, k, row_chunk, stream),
                               ref)

    live = stream[:, 6] > 0.0
    pad_rows = (rows.reshape(-1, k, 12)[:, :, 10] < 0.0).sum(dim=1)
    closed = live & (pad_rows[row_chunk.long()] >= 4).repeat_interleave(128)
    assert int(closed.sum()) > int(live.sum()) // 2
    unmasked = run(_with_padding(rows, k, faces, pid=1.0e6))
    if walk == "any":
        assert bool((unmasked[closed] == 1).all())
        changed = unmasked != ref
    else:
        assert bool((unmasked[1][closed] >= 0.0).all())
        changed = (unmasked != ref).any(dim=0)
    assert int((changed & live).sum()) > int(live.sum()) // 4


def _edge_wave(tch, t_kind, seed=21):
    """N soup rays: an eighth axis-parallel from chunk-box corners, a third
    of those with their zero components -0.0, a fifth dead (t_max 0 or
    -1), and t_max = +inf on a quarter (t_kind "inf") or on none; a tenth
    with no negative direction component, which cross the +inf pad
    chunks when t_max is +inf."""
    o, d = tp.divergent_rays(N, seed, tch.treelet_bounds.numpy())
    rng = np.random.default_rng(seed)
    neg0 = (rng.random((N, 1)) < 0.33) & (d == 0.0)
    d = np.where(neg0, np.float32(-0.0), d)
    pos = rng.random(N) < 0.1
    d[pos] = np.abs(d[pos])
    t_max = np.full(N, F32_MAX, np.float32)
    if t_kind == "inf":
        t_max[(rng.random(N) < 0.25) | pos] = np.inf
    dead = rng.random(N) < 0.2
    t_max[dead] = rng.choice([0.0, -1.0], int(dead.sum()))
    return o, d, t_max


def _xla(jch, o, d, t_max):
    return np.asarray(jts._cross_words_xla(
        jch, *(jnp.asarray(x) for x in (o, d, t_max)))).astype(np.int64)


def _plain(tch, o, d, t_max):
    return ts.cross_words_plain(tch, *(torch.as_tensor(np.ascontiguousarray(
        x)) for x in (o, d, t_max))).numpy()


@pytest.mark.parametrize("t_kind", ["finite", "inf"])
@pytest.mark.parametrize("split", ["slices", "permuted"])
def test_cross_words_are_per_ray(soup, split, t_kind):
    """A wave's words equal the concatenation of its random slices' and,
    on the wave permuted by a seeded permutation, the permuted words; each
    equals yuki_tpu's _cross_words_xla on the same rays."""
    _, jch, _, tch = soup
    assert tch.n_treelets % 32 != 0
    o, d, t_max = _edge_wave(tch, t_kind)
    whole = _plain(tch, o, d, t_max)
    np.testing.assert_array_equal(whole, _xla(jch, o, d, t_max))
    assert not whole[t_max <= 0.0].any()
    rng = np.random.default_rng(31)
    if split == "slices":
        cuts = np.concatenate([[0], np.sort(rng.choice(
            np.arange(1, N), 6, replace=False)), [N]])
        parts = [slice(a, b) for a, b in zip(cuts[:-1], cuts[1:])]
        got = np.concatenate([_plain(tch, o[p], d[p], t_max[p])
                              for p in parts])
        ref = np.concatenate([_xla(jch, o[p], d[p], t_max[p])
                              for p in parts])
        np.testing.assert_array_equal(got, whole)
        np.testing.assert_array_equal(ref, whole)
    else:
        perm = rng.permutation(N)
        got = _plain(tch, o[perm], d[perm], t_max[perm])
        np.testing.assert_array_equal(got, whole[perm])
        np.testing.assert_array_equal(
            _xla(jch, o[perm], d[perm], t_max[perm]), whole[perm])
    # Bits past the last chunk: set only for t_max = +inf rays with no
    # negative direction component, as yuki_tpu sets them.
    past = whole[:, -1] >> (tch.n_treelets % 32)
    inf_pos = np.isinf(t_max) & (~np.signbit(d) | (d == 0.0)).all(axis=1)
    assert (past != 0).any() == (t_kind == "inf")
    assert not past[~inf_pos].any()


def test_cross_tables_are_yukis_and_cached(soup, monkeypatch):
    """cross_tables: word_boxes(..., inf) and the +inf-padded chunk boxes
    as structure of arrays, equal to the tables yuki_tpu's
    _cross_words_tpu hands its Pallas kernel; built once per chunk
    structure, and again when its bounds change in place."""
    _, jch, _, tch = soup
    ch = dataclasses.replace(tch, treelet_bounds=tch.treelet_bounds.clone())
    n_c, w = ch.n_treelets, ts.n_words(ch.n_treelets)
    wsoa, csoa = ts.cross_tables(ch)
    assert wsoa.shape == (6, w) and csoa.shape == (6, 32 * w)
    assert ts.cross_tables(ch)[0] is wsoa
    cb = ch.treelet_bounds
    assert torch.equal(wsoa.T, ts.word_boxes(cb, n_c, float("inf"))[:, 0:6])
    assert torch.equal(csoa.T[:n_c], cb[:, 0:6])
    assert bool(torch.isinf(csoa.T[n_c:]).all())

    seen = {}

    def pallas_call(kernel, grid_spec=None, out_shape=(), **_):
        def call(bb, cbt, packed):
            seen["bb"], seen["cb"] = np.asarray(bb), np.asarray(cbt)
            return [jnp.zeros(s.shape, s.dtype) for s in out_shape]
        return call

    monkeypatch.setattr(jts.pl, "pallas_call", pallas_call)
    o, d = tp.divergent_rays(128, 5)
    jts._cross_words_tpu(jch, jnp.asarray(o), jnp.asarray(d),
                         jnp.full((128,), F32_MAX), interpret=True)
    np.testing.assert_array_equal(wsoa.T.numpy(), seen["bb"][:w, 0:6])
    np.testing.assert_array_equal(csoa.T.numpy(), seen["cb"][:, 0:6])

    cb[0, 0] -= 1.0  # in place: the tables are rebuilt
    wsoa2, csoa2 = ts.cross_tables(ch)
    assert wsoa2 is not wsoa and float(csoa2[0, 0]) == float(cb[0, 0])
    assert torch.equal(wsoa2.T, ts.word_boxes(cb, n_c, float("inf"))[:, 0:6])
