"""The coherence sort of the port's scene queries (yuki_tpu_torch/
traverse.py ray_sort_key, _sorted_call, skip_sort) against yuki_tpu's.

- ``ray_sort_key`` equals yuki_tpu's u32 key bit for bit, eager and under
  jax.jit, on rays with unit, unnormalised (shadow-style: target - origin,
  lengths up to ~20) and zero direction components (axis-parallel rays,
  -0.0 components, the zero vector) and origins inside and outside the
  scene bounds (the cell clip).
- ``_sorted_call`` returns results in the rays' own order (tests/
  test_pairs.py:105-118's round trip), with and without the extra plane.
- ``intersect`` / ``any_intersect`` with ``skip_sort`` False (sorted, the
  default) against True on a treelet soup, on a divergent wave (the slot
  stream: per-ray lists, equal bit for bit) and a coherent one (the row
  engine: a row's lanes change, so prim may differ only at ties, two
  triangles whose t are within an ulp, and t by an ulp).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from yuki_tpu import traverse as jtr
from yuki_tpu_torch import traverse
from yuki_tpu_torch.ops.trace import F32_MAX
from yuki_tpu_torch.scene.data import DENSE_TRI_THRESHOLD

torch.set_num_threads(2)

N = 512


@pytest.fixture(scope="module")
def soup():
    jsc, tsc = tp.soup_scenes(DENSE_TRI_THRESHOLD + 64, 31)
    assert tsc.meta.traversal == "treelet"
    return jsc, tsc


def _key_rays(tsc, seed):
    rng = np.random.default_rng(seed)
    lo = tsc.data.world_lo.numpy()
    hi = tsc.data.world_hi.numpy()
    ext = hi - lo
    o = (lo - 0.2 * ext + rng.random((N, 3)) * 1.4 * ext).astype(np.float32)
    d = rng.standard_normal((N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    shadow = slice(N // 4, N // 2)
    target = lo + rng.random((N // 4, 3)) * ext
    d[shadow] = target - o[shadow]  # unnormalised, as spawn_ray_to makes
    q = np.arange(N // 2, N // 2 + N // 8)
    d[q] = 0.0
    d[q, rng.integers(0, 3, q.size)] = rng.choice([-1.0, 1.0, -7.5], q.size)
    d[q[::3], 0] = -0.0
    d[-3:] = 0.0
    return o, d


def test_sort_key_matches_jax(soup):
    jsc, tsc = soup
    o, d = _key_rays(tsc, 1)
    assert (o < tsc.data.world_lo.numpy()).any()
    assert (np.abs(d).max(axis=1) > 5.0).any() and (d == 0.0).any()
    got = traverse.ray_sort_key(tsc.data, torch.as_tensor(o),
                                torch.as_tensor(d)).numpy()
    assert got.dtype == np.int64 and (got >= 0).all() and (got < 2 ** 24).all()
    ref = np.asarray(jtr.ray_sort_key(jsc.data, jnp.asarray(o),
                                      jnp.asarray(d)))
    assert ref.dtype == np.uint32
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    jitted = jax.jit(jtr.ray_sort_key)(jsc.data, jnp.asarray(o),
                                       jnp.asarray(d))
    np.testing.assert_array_equal(got, np.asarray(jitted).astype(np.int64))
    assert len(np.unique(got >> 21)) == 8  # every octant


def test_sorted_call_roundtrip():
    """fn runs on the sorted rays and its outputs come back in the rays'
    order; the extra plane is sorted with the rays; skip_sort calls fn on
    the natural order."""
    _, tsc = tp.soup_scenes(300, 7)
    assert tsc.meta.traversal == "dense"
    o, d = (torch.as_tensor(x) for x in _key_rays(tsc, 2))
    t_max = torch.full((N,), F32_MAX)
    extra = torch.arange(N, dtype=torch.int32)
    ref = traverse.intersect_dense(tsc.data, o, d, t_max)
    seen = []

    def run(o_s, d_s, t_s, e_s):
        seen.append(e_s)
        return (*traverse.intersect_dense(tsc.data, o_s, d_s, t_s), e_s,
                torch.tensor(7))

    for skip_sort in (False, True):
        out = traverse._sorted_call(tsc.data, o, d, t_max, extra, run,
                                    skip_sort)
        for g, r in zip(out[:4], ref):
            assert torch.equal(g, r)
        assert torch.equal(out[4], extra) and int(out[5]) == 7
    assert not torch.equal(seen[0], extra) and torch.equal(seen[1], extra)
    order = torch.argsort(traverse.ray_sort_key(tsc.data, o, d), stable=True)
    assert torch.equal(seen[0], extra[order])
    assert int((ref[1] >= 0).sum()) > N // 16


def _coherent(seed):
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.3, 0.2, 3.5]], np.float32), (N, 1))
    d = np.stack([rng.uniform(-0.05, 0.05, N), rng.uniform(-0.05, 0.05, N),
                  -np.ones(N)], 1).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True), np.full(
        N, 1.5, np.float32)


@pytest.mark.parametrize("rays", ["divergent", "coherent"])
def test_queries_sorted_against_unsorted(soup, rays):
    _, tsc = soup
    if rays == "coherent":
        o, d, t_max = _coherent(3)
    else:
        o, d = tp.divergent_rays(N, 3, tsc.data.chunks.treelet_bounds.numpy())
        t_max = np.full(N, F32_MAX, np.float32)
    o, d, t_max = (torch.as_tensor(x) for x in (o, d, t_max))
    skip = torch.as_tensor(np.random.default_rng(3).choice(
        [-2, -1], N).astype(np.int32))
    out = {}
    for skip_sort in (False, True):
        traverse.reset_counts()
        hit = traverse.intersect(tsc.data, tsc.meta, o, d, t_max,
                                 skip_sort=skip_sort)
        occ = traverse.any_intersect(tsc.data, tsc.meta, o, d, t_max * 0.5,
                                     skip, skip_sort=skip_sort)
        out[skip_sort] = hit, occ, traverse.counts()
    (h_s, occ_s, c_s), (h_n, occ_n, c_n) = out[False], out[True]
    branch = "rows" if rays == "coherent" else "slot"
    assert c_s[f"closest_{branch}"] == c_n[f"closest_{branch}"] == 1
    assert torch.equal(occ_s, occ_n) and occ_s.any() and not occ_s.all()
    ulp = (h_s.t.view(torch.int32) - h_n.t.view(torch.int32)).abs()
    same = h_s.prim == h_n.prim
    assert bool((ulp[~same] <= 1).all())  # prim differs only at ties
    assert int(ulp.max()) <= 1
    if rays == "divergent":
        for f in ("hit", "t", "prim", "b0", "b1"):
            assert torch.equal(getattr(h_s, f), getattr(h_n, f)), f
    assert int((h_s.prim >= 0).sum()) > N // 4
