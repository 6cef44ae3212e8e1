"""tests/test_combined.py's two contracts of a per-lane ``skip_light`` on
the port's engines (plain versions: these tensors lie on the CPU), and
``bary_count``:

  - skip -2 everywhere gives the query without skip, bit for bit: every
    field of the SceneHit;
  - for shadow lanes (unnormalised directions to a point, the 0.9999
    chord as t_max, their light's id or -2 as skip) the combined call's
    ``.hit`` equals ``any_intersect`` with the same skip.

Engines: the dense skip sweep; on a treelet soup the rows engine (a
coherent wave), the slot stream (a divergent wave), the bundle walker
(both walker flags) and the fallback (a slot budget of zero rows: the
treelet walk, with the shadow lanes' prim patched from the occlusion
walk).  Half of each soup carries area-light id 0.  Also: a scene built
with bun_closest or bun_any above 1 raises where yuki_tpu would take its
bundle engine, and not where it would not.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_parity as tp
from yuki_tpu_torch import traverse
from yuki_tpu_torch.ops import trace_stream as ts
from yuki_tpu_torch.ops.trace import F32_MAX
from yuki_tpu_torch.scene.data import DENSE_TRI_THRESHOLD

torch.set_num_threads(2)

N = 512  # closest lanes; as many shadow lanes follow them


@pytest.fixture(scope="module")
def soups():
    return {"dense": tp.soup_scenes(300, 3, lit=True)[1],
            "treelet": tp.soup_scenes(DENSE_TRI_THRESHOLD + 64, 3,
                                      lit=True)[1]}


def combined_wave(scene, seed, coherent):
    """N closest lanes (skip -2, t_max F32_MAX, a tenth parked with 0) and
    N shadow lanes from points in the soup towards others (skip 0 or -2,
    the 0.9999 chord, a tenth parked); ``coherent``: camera-like closest
    lanes with t_max 1.5 and short shadow segments along -z from nearby
    points."""
    rng = np.random.default_rng(seed)
    if coherent:
        o = np.tile(np.array([[0.3, 0.2, 3.5]], np.float32), (N, 1))
        d = np.stack([rng.uniform(-0.05, 0.05, N),
                      rng.uniform(-0.05, 0.05, N), -np.ones(N)], 1)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        so = np.array([0.3, 0.2, 2.0]) + rng.uniform(-0.05, 0.05, (N, 3))
        target = so + np.array([0.0, 0.0, -1.0]) + rng.uniform(
            -0.05, 0.05, (N, 3))
    else:
        o, d = tp.divergent_rays(N, seed, scene.data.chunks.treelet_bounds
                                 .numpy() if scene.data.chunks else None)
        so = ((rng.random((N, 3)) - 0.5) * 6)
        target = (rng.random((N, 3)) - 0.5) * 6
    t_max = np.full(N, 1.5 if coherent else F32_MAX, np.float32)
    chord = np.full(N, 0.9999, np.float32)
    t_max[rng.random(N) < 0.1] = 0.0
    chord[rng.random(N) < 0.1] = 0.0
    skip = np.concatenate([np.full(N, -2), rng.choice([0, -2], N)])
    return [torch.as_tensor(np.asarray(x, dtype=dt)) for x, dt in (
        (np.concatenate([o, so]), np.float32),
        (np.concatenate([d, target - so]), np.float32),
        (np.concatenate([t_max, chord]), np.float32),
        (skip, np.int32))]


def _equal(a, b):
    for f in ("hit", "t", "prim", "sphere", "b0", "b1"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


ENGINES = {"dense": ("dense", False), "rows": ("treelet", True),
           "slot": ("treelet", False), "walker": ("treelet", False),
           "fallback": ("treelet", False)}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_skip_contracts(soups, monkeypatch, engine):
    kind, coherent = ENGINES[engine]
    scene = soups[kind]
    data, meta = scene.data, scene.meta
    if engine == "walker":
        monkeypatch.setattr(traverse, "WALKER_CLOSEST", True)
        monkeypatch.setattr(traverse, "WALKER_ANY", True)
    if engine == "fallback":
        monkeypatch.setattr(ts, "_max_rows", lambda *a: 0)
    o, d, t, skip = combined_wave(scene, 5, coherent)
    q = dict(skip_sort=True)
    traverse.reset_counts()
    plain = traverse.intersect(data, meta, o, d, t, **q)
    neutral = traverse.intersect(data, meta, o, d, t,
                                 torch.full_like(skip, -2), **q)
    _equal(neutral, plain)
    hit = traverse.intersect(data, meta, o, d, t, skip, **q)
    c = traverse.counts()
    occ = traverse.any_intersect(data, meta, o[N:], d[N:], t[N:], skip[N:],
                                 **q)
    assert torch.equal(hit.hit[N:], occ)
    assert occ.any() and not occ.all()
    lit = skip[N:] == 0
    assert (hit.hit[N:][lit] != plain.hit[N:][lit]).any()  # the skip matters
    for f in ("t", "prim", "b0", "b1"):  # closest lanes do not change
        assert torch.equal(getattr(hit, f)[:N], getattr(plain, f)[:N]), f
    if kind == "treelet":
        name = "closest_" + {"fallback": "slot"}.get(engine, engine)
        assert c[name] == 3 and c["fallbacks"] == (
            3 if engine == "fallback" else 0), c


@pytest.mark.parametrize("engine", ["slot", "fallback"])
def test_bary_count(soups, monkeypatch, engine):
    """bary_count (with skip_sort): barycentrics for the first bary_count
    lanes rounded up to 128, zeros past them; the fallback's treelet walk
    gives every lane its own."""
    scene = soups["treelet"]
    if engine == "fallback":
        monkeypatch.setattr(ts, "_max_rows", lambda *a: 0)
    o, d, t, skip = combined_wave(scene, 6, False)
    full = traverse.intersect(scene.data, scene.meta, o, d, t, skip,
                              skip_sort=True)
    part = traverse.intersect(scene.data, scene.meta, o, d, t, skip,
                              skip_sort=True, bary_count=N - 100)
    for f in ("hit", "t", "prim", "sphere"):
        assert torch.equal(getattr(part, f), getattr(full, f)), f
    nb = -(-(N - 100) // 128) * 128
    assert nb == N
    for f in ("b0", "b1"):
        assert torch.equal(getattr(part, f)[:nb], getattr(full, f)[:nb])
        rest = getattr(part, f)[nb:]
        if engine == "fallback":
            assert torch.equal(rest, getattr(full, f)[nb:])
        else:
            assert not rest.any() and getattr(full, f)[nb:].any()


def test_bundle_engine_raises(soups):
    """bun_closest / bun_any > 1 select yuki_tpu's bundle engine on the
    divergent branch (closest only without a skip): not ported, so the
    port raises there and nowhere else."""
    scene = soups["treelet"]
    o, d, t, skip = combined_wave(scene, 7, False)
    co, cd, ct, cs = combined_wave(scene, 7, True)
    data = scene.data
    meta = dataclasses.replace(scene.meta, bun_closest=2)
    with pytest.raises(NotImplementedError,
                       match=r"bundle engine \(ops/trace_bundles\.py.*is not "
                       r"ported"):
        traverse.intersect(data, meta, o[:N], d[:N], t[:N], skip_sort=True)
    traverse.intersect(data, meta, o, d, t, skip, skip_sort=True)
    traverse.intersect(data, meta, co[:N], cd[:N], ct[:N], skip_sort=True)
    traverse.any_intersect(data, meta, o[N:], d[N:], t[N:], skip[N:])
    meta = dataclasses.replace(scene.meta, bun_any=2)
    with pytest.raises(NotImplementedError,
                       match=r"bundle engine \(ops/trace_bundles\.py.*is not "
                       r"ported"):
        traverse.any_intersect(data, meta, o[N:], d[N:], t[N:], skip[N:],
                               skip_sort=True)
    traverse.intersect(data, meta, o[:N], d[:N], t[:N], skip_sort=True)
