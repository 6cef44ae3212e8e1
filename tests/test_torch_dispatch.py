"""The port's treelet dispatch (yuki_tpu_torch/traverse.py) against
yuki_tpu.traverse, and its probe (ops/trace_rows.py).

The probe's words and demand are held bit for bit.  The whole dispatch is
held against yuki_tpu's intersect / any_intersect with
traverse.FORCE_PALLAS_INTERPRET set (yuki_tpu's own test hook, as
tests/test_cull_fused.py uses it) on a treelet soup (check_dispatch):
divergent rays, so that both take the slot branch, plainly, with an
overflow re-run, and with a blown slot budget that falls back to the
treelet walk; coherent rays, so that both take the rows branch, plainly
and with rows cut at a narrow list width that re-run through the wide
pass.  prim and occlusion must be equal.  yuki_tpu's kernels run
in interpret mode, which XLA compiles and may contract into FMAs, so t
is held to rtol 2e-5 and b0/b1 to atol 1e-5 (assert_dispatch_agrees);
the port's own parts are held bit for bit in test_torch_stream.py and
test_torch_cull.py.  yuki_tpu compiles its whole dispatch for each call
(about a minute for intersect, half that for any_intersect on one
worker), so the closest query lives here and the occlusion, fallback and
rows cases in test_torch_dispatch_{any,fallback,fallback_any,rows,
rows_any}.py.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from yuki_tpu import traverse as jtr
from yuki_tpu.ops import trace_rows as jrows
from yuki_tpu.ops import trace_stream as jts
from yuki_tpu_torch import traverse
from yuki_tpu_torch.device import default_device
from yuki_tpu_torch.ops import trace_stream as ts
from yuki_tpu_torch.ops import trace_treelets as ttt
from yuki_tpu_torch.ops.trace import F32_MAX
from yuki_tpu_torch.ops.trace_rows import row_words_interval
from yuki_tpu_torch.scene.data import DENSE_TRI_THRESHOLD
from yuki_tpu_torch.treelets import build_treelets

torch.set_num_threads(2)

N = 512


@pytest.fixture(scope="module")
def soup():
    """A treelet soup of DENSE_TRI_THRESHOLD + 64 triangles (33 chunks,
    below CROSS_2L_MIN_CHUNKS: crossing words and extract_lists)."""
    jsc, tsc = tp.soup_scenes(DENSE_TRI_THRESHOLD + 64, 31)
    assert tsc.meta.traversal == "treelet"
    assert dataclasses.asdict(tsc.meta) == dataclasses.asdict(jsc.meta)
    return jsc, tsc


def _divergent(tsc, seed):
    o, d = tp.divergent_rays(N, seed, tsc.data.chunks.treelet_bounds.numpy())
    t_max = np.full(N, F32_MAX, np.float32)
    t_max[np.random.default_rng(seed).random(N) < 0.15] = 0.0
    return o, d, t_max


def _coherent(seed):
    """Camera-like rays: one origin just outside the soup, directions
    within a narrow cone, t_max 1.5 (a few chunks per row)."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.3, 0.2, 3.5]], np.float32), (N, 1))
    d = np.stack([rng.uniform(-0.05, 0.05, N), rng.uniform(-0.05, 0.05, N),
                  -np.ones(N)], 1).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True), np.full(
        N, 1.5, np.float32)


@pytest.mark.parametrize("rays", ["divergent", "coherent", "ragged"])
def test_probe_matches_jax(soup, rays):
    """row_words_interval and _rows_demand bit for bit; divergent rows
    demand more than the rows engine holds, coherent ones less."""
    jsc, tsc = soup
    o, d, t_max = (_coherent(1) if rays == "coherent"
                   else _divergent(tsc, 2))
    if rays == "ragged":  # padded to whole rows as the dispatch pads them
        o, d, t_max = (x[:1000] for x in (o, d, t_max))
        o, d, t_max = (np.array(x) for x in jtr._pad128(
            jsc.data, *(jnp.asarray(x) for x in (o, d, t_max))))
        got = traverse._pad128(tsc.data, *(torch.as_tensor(x[:1000])
                                            for x in (o, d, t_max)))
        for g, r in zip(got, (o, d, t_max)):
            np.testing.assert_array_equal(g.numpy(), r)
    ref = jrows.row_words_interval(jsc.data.chunks,
                                   *(jnp.asarray(x) for x in (o, d, t_max)))
    got = row_words_interval(tsc.data.chunks,
                             *(torch.as_tensor(x) for x in (o, d, t_max)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref).astype(np.int64))
    demand = int(traverse._rows_demand(got))
    assert demand == int(jtr._rows_demand(ref))
    assert (demand <= (N // 128) * traverse._ROWS_MULT) == (
        rays == "coherent")


def jax_dispatch(jsc, query, o, d, t_max, skip):
    """yuki_tpu's intersect ("closest": SceneHit as numpy) or any_intersect
    ("any", chord 2.5: occluded) with its treelet engines in interpret
    mode."""
    old = jtr.FORCE_PALLAS_INTERPRET
    jtr.FORCE_PALLAS_INTERPRET = True
    try:
        o, d, t_max = (jnp.asarray(x) for x in (o, d, t_max))
        if query == "closest":
            hit = jtr.intersect(jsc.data, jsc.meta, o, d, t_max,
                                skip_sort=True)
            return type(hit)(*(np.asarray(x) for x in hit))
        return np.asarray(jtr.any_intersect(
            jsc.data, jsc.meta, o, d, jnp.where(t_max > 0, 2.5, 0.0),
            jnp.asarray(skip), skip_sort=True))
    finally:
        jtr.FORCE_PALLAS_INTERPRET = old


def port_dispatch(tsc, query, o, d, t_max, skip):
    o, d, t_max = (torch.as_tensor(x) for x in (o, d, t_max))
    if query == "closest":
        hit = traverse.intersect(tsc.data, tsc.meta, o, d, t_max)
        return type(hit)(*(x.numpy() for x in hit))
    return traverse.any_intersect(tsc.data, tsc.meta, o, d,
                                  torch.where(t_max > 0, 2.5, 0.0),
                                  torch.as_tensor(skip)).numpy()


def dispatch_rays(tsc, seed=3, rays="divergent"):
    o, d, t_max = _coherent(seed) if rays == "coherent" else _divergent(
        tsc, seed)
    skip = np.random.default_rng(seed).choice([-2, -1, 0], N).astype(
        np.int32)
    return o, d, t_max, skip


def assert_dispatch_agrees(query, ref, got):
    """Occlusion equal; prim and hit equal, t to rtol 2e-5 (interpret
    mode's FMA contraction of the edge functions, measured at most
    1.2e-5, 104 ulps, on 1024 such rays), b0/b1 to atol 1e-5 (measured
    equal)."""
    if query == "any":
        np.testing.assert_array_equal(got, ref)
        assert got.any() and not got.all()
        return
    np.testing.assert_array_equal(got.prim, ref.prim)
    np.testing.assert_array_equal(got.hit, ref.hit)
    np.testing.assert_allclose(got.t, ref.t, rtol=2e-5)
    hit = got.prim >= 0
    assert hit.sum() > N // 2
    for f in ("b0", "b1"):
        np.testing.assert_allclose(getattr(got, f)[hit],
                                   getattr(ref, f)[hit], atol=1e-5)


def _no_walk(*_):
    raise AssertionError("the treelet walk ran outside a fallback")


def check_dispatch(soup, query, monkeypatch, cases, rays="divergent"):
    """The port's dispatch against yuki_tpu's on ``rays`` ("divergent":
    the slot branch; "coherent": the rows branch), for each of ``cases``:
    "plain"; "overflow" with the port's list width (C_MAIN, or the rows
    engine's _ROWS_C) lowered to 2, so that many rays re-run through the
    crossing words and the wide pass (yuki_tpu's answers do not depend on
    C, so one yuki_tpu call serves both); "fallback" with a budget of 8
    slot rows on both sides, so that the wave goes to the treelet walk.
    Outside "fallback" the port's treelet walk must not run."""
    jsc, tsc = soup
    branch = "rows" if rays == "coherent" else "slot"
    rays = dispatch_rays(tsc, rays=rays)
    with monkeypatch.context() as m:
        if "fallback" in cases:
            m.setattr(jts, "_max_rows", lambda *a: 8)
        ref = jax_dispatch(jsc, query, *rays)
    for case in cases:
        with monkeypatch.context() as m:
            if case == "overflow":
                # (Lowering _ROWS_C also lowers the probe's demand, so it
                # would turn a divergent wave coherent.)
                m.setattr(*((traverse, "_ROWS_C") if branch == "rows"
                            else (ts, "C_MAIN")), 2)
            if case == "fallback":
                m.setattr(ts, "_max_rows", lambda *a: 8)
            else:
                for walk in ("treelet_closest", "treelet_any"):
                    m.setattr(traverse, walk, _no_walk)
            traverse.reset_counts()
            got = port_dispatch(tsc, query, *rays)
        assert_dispatch_agrees(query, ref, got)
        c = traverse.counts()
        assert c[f"{query}_{branch}"] == 1
        assert c["fallbacks"] == (case == "fallback")
        assert (c["wide_reruns"] == 1) == (case == "overflow")
        if case == "overflow":
            assert c["overflow_rays"] > N // 8


def test_closest_dispatch_matches_jax(soup, monkeypatch):
    check_dispatch(soup, "closest", monkeypatch, ("plain", "overflow"))


def test_coherent_wave_takes_the_walk(soup):
    """A wave the probe calls coherent takes the rows engine, not the
    treelet walk, and agrees with the walk: prim and b0/b1 equal, t within
    an ulp (the rows engine divides a scaled hit once, the walk multiplies
    by a reciprocal)."""
    _, tsc = soup
    o, d, t_max = (torch.as_tensor(x) for x in _coherent(4))
    traverse.reset_counts()
    hit = traverse.intersect(tsc.data, tsc.meta, o, d, t_max)
    t, prim, b0, b1 = ttt.treelet_closest(tsc.data.treelets, o, d, t_max)
    assert torch.equal(hit.prim, prim) and int((prim >= 0).sum()) > N // 2
    ulp = (hit.t.view(torch.int32) - t.view(torch.int32)).abs()
    assert int(ulp.max()) <= 1
    assert torch.equal(hit.b0, b0) and torch.equal(hit.b1, b1)
    c = traverse.counts()
    assert c["closest_rows"] == 1 and c["closest_slot"] == 0
    assert c["fallbacks"] == 0


def test_build_treelets_default_device(soup):
    """device=None means default_device(), the card: without one,
    build_treelets, like every entry point of the port, raises and names
    device="cpu" instead of running on the CPU."""
    _, tsc = soup
    assert default_device() == torch.device("cuda")
    tri = torch.stack([tsc.data.tris.p0, tsc.data.tris.p1,
                       tsc.data.tris.p2], dim=1).numpy()
    light = tsc.data.tris.area_light.numpy()
    if torch.cuda.is_available():
        tl = build_treelets(tsc.bvh_host, tri, light, leaf_size=64)
        assert tl.rows.device.type == tl.super_bounds.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_treelets(tsc.bvh_host, tri, light, leaf_size=64)
    tl = build_treelets(tsc.bvh_host, tri, light, leaf_size=64, device="cpu")
    assert tl.rows.device.type == tl.super_bounds.device.type == "cpu"
