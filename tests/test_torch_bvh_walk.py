"""The threaded BVH on the device and its walks (yuki_tpu_torch.bvh.
BvhArrays, traverse.intersect_bvh, any_intersect_bvh, intersect
with_stats) against yuki_tpu.

``BvhArrays`` equals yuki_tpu's device BVH bit for bit, as the port's
SceneBuilder builds it and through the bridge's ``bvh.*`` leaves.  The
closest walk is held against yuki_tpu's intersect_bvh run eagerly
(jax.disable_jit(): its while_loop becomes a Python loop, op by op, so no
FMA is contracted): steps equal lane for lane, t, prim, b0 and b1 bit for
bit, with and without a skip light; the occlusion walk against
yuki_tpu's walk (a dense scene's meta with traversal "bvh" routes
any_intersect to it).  On a treelet soup the walks are held against the
port's adaptive dispatch: prim and occlusion equal apart from counted
ties; t, which the walk computes as yuki_tpu's ray_triangle does (the sum
of e_i * (p_iz * sz) times 1 / det) and the dispatch's engines as
yuki_tpu's kernels do (the scaled hit over det), within 1e-5 relative
and one ulp at the median (measured: 3.8e-6 relative, 45 ulps, at t =
0.0056 just off a triangle; 4 ulps at the 99th percentile)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from yuki_tpu import traverse as jtr
from yuki_tpu_torch import traverse
from yuki_tpu_torch.bvh import BvhArrays
from yuki_tpu_torch.ops.trace import F32_MAX
from yuki_tpu_torch.scene.data import DENSE_TRI_THRESHOLD

torch.set_num_threads(2)

N = 384
FIELDS = [f.name for f in dataclasses.fields(BvhArrays)]


def _scenes(name):
    if name == "soup":
        jsc, tsc = tp.soup_scenes(300, 7, lit=True)
        return jsc, tsc
    return tp.jax_scene(name)[0], tp.port_scene(name)[0]


def _rays(tsc, seed, n=N):
    lo = tsc.data.world_lo.numpy()
    hi = tsc.data.world_hi.numpy()
    o, d = tp.divergent_rays(n, seed, span=1.0)
    o = (lo + (o + 0.5) * (hi - lo)).astype(np.float32)
    t_max = np.full(n, F32_MAX, np.float32)
    t_max[: n // 8] = 0.0  # parked lanes
    t_max[n // 8: n // 4] = 0.5
    return o, d, t_max


@pytest.mark.parametrize("name", ["cornell", "soup", "midsize"])
def test_bvh_arrays_match_jax(name):
    jsc, tsc = _scenes(name)
    for got in (tsc.data.bvh, tp.bridged(jsc).data.bvh):
        for f in FIELDS:
            a = np.asarray(getattr(jsc.data.bvh, f))
            b = getattr(got, f).numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("name,skip", [("cornell", False), ("soup", True),
                                       ("midsize", False)])
def test_intersect_bvh_matches_jax(name, skip):
    jsc, tsc = _scenes(name)
    o, d, t_max = _rays(tsc, 3)
    sk = None
    if skip:
        sk = np.where(np.arange(N) % 2 == 0, 0, -2).astype(np.int32)
    with jax.disable_jit():
        ref = jtr.intersect_bvh(
            jsc.data, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
            jsc.meta.bvh_max_leaf, with_stats=True,
            skip_light=None if sk is None else jnp.asarray(sk))
    got = traverse.intersect_bvh(
        tsc.data, torch.as_tensor(o), torch.as_tensor(d),
        torch.as_tensor(t_max), tsc.meta.bvh_max_leaf, with_stats=True,
        skip_light=None if sk is None else torch.as_tensor(sk))
    for k, g, r in zip(("t", "prim", "b0", "b1", "steps"), got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=k)
    assert (got[1] >= 0).sum() > 10 and int(got[4].max()) > 5


@pytest.mark.parametrize("name", ["cornell", "midsize"])
def test_any_intersect_bvh_matches_jax(name):
    jsc, tsc = _scenes(name)
    o, d, t_max = _rays(tsc, 4)
    ext = tsc.data.world_hi - tsc.data.world_lo
    t_max[N // 4:] = 0.3 * float(ext.norm())
    skip = np.where(np.arange(N) % 3 == 0, 0, -2).astype(np.int32)
    meta = dataclasses.replace(jsc.meta, traversal="bvh")
    with jax.disable_jit():
        ref = jtr.any_intersect(jsc.data, meta, jnp.asarray(o),
                                jnp.asarray(d), jnp.asarray(t_max),
                                jnp.asarray(skip))
    got = traverse.any_intersect_bvh(tsc.data, tsc.meta, torch.as_tensor(o),
                                     torch.as_tensor(d),
                                     torch.as_tensor(t_max),
                                     torch.as_tensor(skip))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0.05 < got.float().mean() < 0.95


def test_walks_compact_without_changing_results():
    """The walk drops ended rays from its working set when they are half
    of it: each ray's result equals its walk alone."""
    _, tsc = _scenes("cornell")
    o, d, t_max = (torch.as_tensor(x) for x in _rays(tsc, 5))
    traverse.reset_counts()
    full = traverse.intersect_bvh(tsc.data, o, d, t_max,
                                  tsc.meta.bvh_max_leaf, with_stats=True)
    c = traverse.counts()
    assert c["bvh_walks"] == 1
    assert c["bvh_steps"] == int(full[4].max()) + 1 == c["host_syncs"]
    for i in (0, N // 8, N // 2, N - 1):
        one = traverse.intersect_bvh(tsc.data, o[i:i + 1], d[i:i + 1],
                                     t_max[i:i + 1], tsc.meta.bvh_max_leaf,
                                     with_stats=True)
        for g, r in zip(one, full):
            assert torch.equal(g, r[i:i + 1])


@pytest.fixture(scope="module")
def treelet_soup():
    _, tsc = tp.soup_scenes(DENSE_TRI_THRESHOLD + 64, 31, lit=True)
    assert tsc.meta.traversal == "treelet"
    return tsc


def _ulp_gap(a, b):
    return tp.ulps(a.numpy(), b.numpy())


def test_walk_agrees_with_dispatch(treelet_soup):
    """intersect(with_stats=True) walks the BVH on a treelet scene; the
    dispatch (sorted, as Whitted calls it) agrees on hit and prim apart
    from ties, and on t as the module docstring states."""
    tsc = treelet_soup
    o, d, t_max = (torch.as_tensor(x) for x in tp.divergent_rays(
        512, 8, tsc.data.chunks.treelet_bounds.numpy()) + (
        np.full(512, F32_MAX, np.float32),))
    hit_w, steps = traverse.intersect(tsc.data, tsc.meta, o, d, t_max,
                                      with_stats=True)
    hit_d = traverse.intersect(tsc.data, tsc.meta, o, d, t_max)
    assert steps.shape == (512,) and int(steps.max()) > 5
    m = hit_w.hit.numpy()
    gap = _ulp_gap(hit_w.t, hit_d.t)
    assert np.median(gap[m]) <= 1
    np.testing.assert_allclose(hit_w.t.numpy(), hit_d.t.numpy(), rtol=1e-5)
    ties = (hit_w.prim != hit_d.prim).numpy()
    assert ties.sum() <= 2
    assert torch.equal(hit_w.hit, hit_d.hit)
    assert hit_w.hit.float().mean() > 0.3


def test_any_walk_agrees_with_dispatch(treelet_soup):
    """The occlusion walk against the dispatch's occlusion on shadow-like
    segments with skip ids: equal."""
    tsc = treelet_soup
    o, d = tp.divergent_rays(512, 9, tsc.data.chunks.treelet_bounds.numpy())
    t_max = np.random.default_rng(2).random(512).astype(np.float32) * 3.0
    skip = np.where(np.arange(512) % 2 == 0, 0, -2).astype(np.int32)
    args = tuple(torch.as_tensor(x) for x in (o, d, t_max, skip))
    occ_w = traverse.any_intersect_bvh(tsc.data, tsc.meta, *args)
    occ_d = traverse.any_intersect(tsc.data, tsc.meta, *args)
    assert torch.equal(occ_w, occ_d)
    assert 0.1 < occ_w.float().mean() < 0.9
