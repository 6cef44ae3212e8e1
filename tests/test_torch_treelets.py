"""The port's treelet structure (yuki_tpu_torch.treelets), treelet scenes
(SceneBuilder.build, colonnade) and plain treelet walks
(ops/trace_treelets.py) against the JAX package.

The structures must hold the same values: bounds, ranges, counts and row
columns 0-10 (the port keeps 12 columns per row, yuki_tpu 128).  The
walks are held against yuki_tpu's Pallas kernels in interpret mode: prim
ids and occlusion exactly; t, b0 and b1 to the tolerance yuki_tpu's own
treelet test uses against its dense sweep (rtol 1e-5 on t, atol 1e-5 on
the barycentrics), because the JAX kernel runs under jit and XLA
contracts the edge functions' a*b - c*d into FMAs while the port rounds
each product (measured: max 2.4e-6 on b1 over these rays, no prim flip).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from yuki_tpu import transforms as jtf
from yuki_tpu.ops.trace_treelets import treelet_any as jax_any
from yuki_tpu.ops.trace_treelets import treelet_closest as jax_closest
from yuki_tpu.scene import data as jdata
from yuki_tpu.treelets import build_treelets as jax_build_treelets
from yuki_tpu_torch import transforms as tf
from yuki_tpu_torch.ops import trace_treelets as ttt
from yuki_tpu_torch.ops.trace import F32_MAX, watertight
from yuki_tpu_torch.scene import data as tdata
from yuki_tpu_torch.treelets import build_treelets

torch.set_num_threads(2)

N = 1024


def _tri_p(scene_tris):
    return np.stack([np.asarray(scene_tris.p0), np.asarray(scene_tris.p1),
                     np.asarray(scene_tris.p2)], axis=1)


@pytest.fixture(scope="module")
def soup():
    """JAX and port soup scenes with their 16/64 treelet cuts."""
    jsc = tp.soup(jdata, jtf)
    tsc = tp.soup(tdata, tf, device="cpu")
    tri = _tri_p(jsc.data.tris)
    light = np.asarray(jsc.data.tris.area_light)
    jtl = jax_build_treelets(jsc.bvh_host, tri, light, leaf_size=16,
                             super_size=64)
    ttl = build_treelets(tsc.bvh_host, tri, light, leaf_size=16,
                         super_size=64, device="cpu")
    return jsc, tsc, jtl, ttl


@pytest.fixture(scope="module")
def colonnade_pair():
    jsc, _ = tp.jax_scene("colonnade")
    tsc, _ = tp.port_scene("colonnade")
    return jsc, tsc


def _assert_same_treelets(jtl, ttl):
    for name in ("leaf_size", "n_supers", "n_treelets", "ts_max"):
        assert getattr(jtl, name) == getattr(ttl, name), name
    np.testing.assert_array_equal(np.asarray(jtl.super_bounds),
                                  ttl.super_bounds.numpy())
    np.testing.assert_array_equal(np.asarray(jtl.super_range),
                                  ttl.super_range.numpy())
    np.testing.assert_array_equal(np.asarray(jtl.treelet_bounds),
                                  ttl.treelet_bounds.numpy())
    rows = np.asarray(jtl.tris_padded)
    assert ttl.rows.shape == (rows.shape[0], 12)
    np.testing.assert_array_equal(rows[:, :11], ttl.rows.numpy()[:, :11])
    assert not ttl.rows[:, 11].any()


def test_treelets_match_jax_on_soup(soup):
    _, _, jtl, ttl = soup
    _assert_same_treelets(jtl, ttl)
    pad = ttl.rows[:, 10] < 0
    assert pad.any() and (ttl.rows[pad, 9] == -3.0).all()


@pytest.mark.parametrize("group", ["treelets", "chunks"])
def test_treelets_match_jax_on_colonnade(colonnade_pair, group):
    """64/4096 treelets and 128/128 chunks, as SceneBuilder.build cuts
    them."""
    jsc, tsc = colonnade_pair
    _assert_same_treelets(getattr(jsc.data, group), getattr(tsc.data, group))


def test_colonnade_meta_and_bounds_match(colonnade_pair):
    jsc, tsc = colonnade_pair
    assert dataclasses.asdict(tsc.meta) == dataclasses.asdict(jsc.meta)
    assert tsc.meta.traversal == "treelet"
    np.testing.assert_array_equal(tsc.data.world_lo.numpy(),
                                  np.asarray(jsc.data.world_lo))
    np.testing.assert_array_equal(tsc.data.world_hi.numpy(),
                                  np.asarray(jsc.data.world_hi))


def test_bridge_round_trips_treelet_scene(colonnade_pair):
    jsc, tsc = colonnade_pair
    br = tp.bridged(jsc)
    assert br.meta == tsc.meta
    for group in ("treelets", "chunks"):
        a, b = getattr(br.data, group), getattr(tsc.data, group)
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, torch.Tensor):
                assert torch.equal(va, vb), f"{group}.{f.name}"
            else:
                assert va == vb, f"{group}.{f.name}"
    for f in dataclasses.fields(tsc.bvh_host):
        np.testing.assert_array_equal(getattr(br.bvh_host, f.name),
                                      getattr(tsc.bvh_host, f.name))
    assert torch.equal(br.data.tris.shading_packed,
                       tsc.data.tris.shading_packed)


# --------------------------------------------------------------------
# The plain walks against yuki_tpu's kernels (interpret mode)
# --------------------------------------------------------------------


def _rays(seed, axis_parallel=False, boxes=None):
    rng = np.random.default_rng(seed)
    o = ((rng.random((N, 3), np.float32) - 0.5) * 6).astype(np.float32)
    d = rng.standard_normal((N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if axis_parallel:
        # Direction components exactly 0 (1/d = inf) and origins on box
        # planes, so (lo - o) * inf = NaN in the slab tests.
        axis = rng.integers(0, 3, N)
        d = np.zeros((N, 3), np.float32)
        d[np.arange(N), axis] = rng.choice([-1.0, 1.0], N)
        lo = boxes[rng.integers(0, boxes.shape[0], N), :3]
        o[: N // 2] = lo[: N // 2]
    return o, d


def _both_closest(jtl, ttl, o, d, t_max):
    ref = [np.asarray(x) for x in jax_closest(
        jtl, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
        interpret=True)]
    got = [x.numpy() for x in ttt.treelet_closest(
        ttl, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max))]
    return ref, got


@pytest.mark.parametrize("axis_parallel", [False, True])
def test_plain_closest_matches_jax(soup, axis_parallel):
    _, _, jtl, ttl = soup
    o, d = _rays(1, axis_parallel, ttl.treelet_bounds.numpy())
    t_max = np.full(N, F32_MAX, np.float32)
    t_max[::9] = 0.0  # parked lanes
    ref, got = _both_closest(jtl, ttl, o, d, t_max)
    np.testing.assert_array_equal(got[1], ref[1])
    hit = got[1] >= 0
    assert hit.sum() > 50
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(got[2][hit], ref[2][hit], atol=1e-5)
    np.testing.assert_allclose(got[3][hit], ref[3][hit], atol=1e-5)


@pytest.mark.parametrize("axis_parallel", [False, True])
def test_plain_any_matches_jax(soup, axis_parallel):
    _, _, jtl, ttl = soup
    o, d = _rays(2, axis_parallel, ttl.treelet_bounds.numpy())
    t_max = np.full(N, 2.5, np.float32)
    skip = np.full(N, -2, np.int32)
    ref = np.asarray(jax_any(jtl, jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(t_max), jnp.asarray(skip),
                             interpret=True))
    got = ttt.treelet_any(ttl, torch.as_tensor(o), torch.as_tensor(d),
                          torch.as_tensor(t_max), torch.as_tensor(skip))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.any()


def test_skip_semantics(soup):
    """-2 skips nothing; -1 matches every ordinary triangle's light id and
    skips the whole scene (yuki_tpu test_treelets.py:102-116)."""
    _, _, _, ttl = soup
    o, d = _rays(3)
    t_max = torch.full((N,), 2.5)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    occ = ttt.treelet_any(ttl, o, d, t_max, torch.full((N,), -2, dtype=torch.int32))
    none = ttt.treelet_any(ttl, o, d, t_max, torch.full((N,), -1, dtype=torch.int32))
    assert occ.any() and not none.any()


def _sequential_closest(tl, o, d, t_max):
    """The walk written out one row at a time, as the TPU kernel runs it:
    every lane of a visiting block tests row k against its running t
    before row k+1 (the reference for the plain walk's batched accept)."""
    (ox, oy, oz, dx, dy, dz, tm), n = ttt._pack(o, d, t_max)
    rays = ttt._Rays(ox, oy, oz, dx, dy, dz)
    t = tm.clone()
    prim = torch.full_like(tm, -1, dtype=torch.int32)
    b0 = torch.zeros_like(tm)
    b1 = torch.zeros_like(tm)
    k = tl.leaf_size
    for s in range(tl.n_supers):
        if not bool(rays.slab(tl.super_bounds[s], t).any()):
            continue
        t0, tc = tl.super_range[s].tolist()
        for tt in range(t0, t0 + tc):
            if not bool(rays.slab(tl.treelet_bounds[tt], t).any()):
                continue
            for r in range(tt * k, (tt + 1) * k):
                row = tl.rows[r]
                hit, ti, bi0, bi1 = watertight(ox, oy, oz, dx, dy, dz, t,
                                               row[:9].unbind())
                closer = hit & (ti < t) & (row[10] >= 0)
                t = torch.where(closer, ti, t)
                prim = torch.where(closer, row[10].to(torch.int32), prim)
                b0 = torch.where(closer, bi0, b0)
                b1 = torch.where(closer, bi1, b1)
    return (t.reshape(-1)[:n], prim.reshape(-1)[:n], b0.reshape(-1)[:n],
            b1.reshape(-1)[:n])


def test_batched_accept_equals_sequential_walk(soup):
    """The plain walk's batched rows + in-order accept rounds give the
    row-by-row walk's results bit for bit (one block, so the block skip
    is the same test)."""
    _, _, _, ttl = soup
    o, d = _rays(4)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    t_max = torch.full((N,), F32_MAX)
    got = ttt.treelet_closest(ttl, o, d, t_max)
    ref = _sequential_closest(ttl, o, d, t_max)
    for a, b, name in zip(got, ref, ("t", "prim", "b0", "b1")):
        assert torch.equal(a, b), name
    assert int((got[1] >= 0).sum()) > 100


def test_cpu_walks_count_no_launches(soup):
    _, _, _, ttl = soup
    ttt.reset_launches()
    o, d = _rays(5)
    ttt.treelet_closest(ttl, torch.as_tensor(o), torch.as_tensor(d),
                        torch.full((N,), F32_MAX))
    assert ttt.LAUNCHES == {"treelet_closest": 0, "treelet_any": 0,
                            "treelet_votes": 0}


def _per_ray_work(tl, o, d, t_max, skip=None):
    """(boxes, triangle tests, treelets) that a walk of each ray alone
    makes, row by row: every super box; a super's treelet boxes where the
    ray's slab passes it; a treelet's real rows where the ray's slab passes
    it, and for occlusion (``skip`` given) up to the first occluding row
    and nothing more once occluded."""
    k = tl.leaf_size
    boxes = tests = 0
    needed = set()
    for i in range(o.shape[0]):
        ox, oy, oz, dx, dy, dz = (x.reshape(1) for x in (*o[i], *d[i]))
        inv = (torch.reciprocal(dx), torch.reciprocal(dy),
               torch.reciprocal(dz))
        t = t_max[i].reshape(1)
        occluded = False
        for s in range(tl.n_supers):
            if occluded:
                break
            boxes += 1
            if not bool(ttt._slab(tl.super_bounds[s], ox, oy, oz, *inv, t)):
                continue
            t0, tc = tl.super_range[s].tolist()
            for tt in range(t0, t0 + tc):
                if occluded:
                    break
                boxes += 1
                if not bool(ttt._slab(tl.treelet_bounds[tt], ox, oy, oz,
                                      *inv, t)):
                    continue
                for row in tl.rows[tt * k:(tt + 1) * k]:
                    if row[10] < 0:
                        continue
                    tests += 1
                    needed.add(tt)
                    hit, ti, _, _ = watertight(ox, oy, oz, dx, dy, dz, t,
                                               row[:9].unbind())
                    if skip is None:
                        if bool(hit & (ti < t)):
                            t = ti
                    elif bool(hit) and float(row[9]) != float(skip[i]):
                        occluded = True
                        break
    return boxes, tests, len(needed)


@pytest.mark.parametrize("query", ["closest", "any"])
def test_plain_walk_counts_the_work_of_each_ray(soup, query):
    """The plain walks' tallies (which chip_smoke.py turns into the walk
    kernels' bounds) count what each ray's own query needs: not the other
    lanes of its block, not padding lanes or rows."""
    _, _, _, ttl = soup
    o, d = _rays(6)
    n = 24
    o, d = torch.as_tensor(o[:n]), torch.as_tensor(d[:n])
    # Ray 0 starts outside the scene and points away: only the super boxes.
    o[0] = torch.tensor([50.0, 50.0, 50.0])
    d[0] = torch.tensor([0.6, 0.0, 0.8])
    t_max = torch.full((n,), 2.5 if query == "any" else F32_MAX)
    t_max[5] = 0.0  # a parked lane
    stats = {}
    if query == "closest":
        ttt.treelet_closest_plain(ttl, o, d, t_max, stats)
        ref = _per_ray_work(ttl, o, d, t_max)
    else:
        skip = torch.full((n,), -2, dtype=torch.int32)
        ttt.treelet_any_plain(ttl, o, d, t_max, skip, stats)
        ref = _per_ray_work(ttl, o, d, t_max, skip)
    assert (stats["boxes"], stats["tests"], stats["treelets"]) == ref
    assert ref[1] > 0
    alone = {}
    ttt.treelet_closest_plain(ttl, o[:1], d[:1], t_max[:1], alone)
    assert alone == {"boxes": ttl.n_supers, "tests": 0, "treelets": 0}
