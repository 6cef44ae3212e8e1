"""The skip-light closest walks (the dense skip sweep and the with_skip
variants of the rows, slot and bundle walks) against their plain PyTorch
versions, on the card, and the whole dispatch with skip on the card
against the CPU.  Marked ``cuda``: they skip where
torch.cuda.is_available() is False.  This file imports no JAX, so on the
card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_skip.py

Both sides run on the same card and must agree bit for bit.  Skip ids are
drawn from -2 (matches nothing), -1 (every triangle that is not an area
light) and 0 (the colonnade's rect light).
"""

import numpy as np
import pytest
import torch

from test_torch_cuda_stream import _rays, _to_cpu, cuda, scenes  # noqa: F401
from yuki_tpu_torch import traverse
from yuki_tpu_torch.ops import trace as ttr
from yuki_tpu_torch.ops import trace_cull as tcu
from yuki_tpu_torch.ops import trace_rows as trw
from yuki_tpu_torch.ops import trace_stream as ts
from yuki_tpu_torch.ops import trace_walker as tw

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)

N = 4096


def _skip(n, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.choice([-2, -1, 0], n).astype(np.int32),
                           device=dev)


def test_dense_skip_matches_plain(cuda):
    """dense_trace_skip on a 1500-triangle soup with light ids -1, 0, 1;
    skip -2 everywhere gives dense_trace's bits."""
    rng = np.random.default_rng(1)
    t = 1500
    base = (rng.random((t, 1, 3)) - 0.5) * 6
    tri = (base + rng.standard_normal((t, 3, 3)) * 0.25).reshape(t, 9)
    tris = torch.as_tensor(np.concatenate([tri, np.zeros((t, 3))], 1)
                           .astype(np.float32), device=cuda)
    light = torch.as_tensor(rng.integers(-1, 2, t).astype(np.int32),
                            device=cuda)
    o = torch.as_tensor(((rng.random((N, 3)) - 0.5) * 6).astype(np.float32),
                        device=cuda)
    d = torch.as_tensor(rng.standard_normal((N, 3)).astype(np.float32),
                        device=cuda)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    t_max = torch.full((N,), ttr.F32_MAX, device=cuda)
    t_max[::7] = 0.0
    skip = _skip(N, 2, cuda)
    ttr.reset_launches()
    got = ttr.dense_trace_skip(tris, light, o, d, t_max, skip)
    ref = ttr.dense_trace_skip_plain(tris, light, o, d, t_max, skip)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert ttr.LAUNCHES["dense_closest_skip"] == 1
    neutral = ttr.dense_trace_skip(tris, light, o, d, t_max,
                                   torch.full_like(skip, -2))
    for g, r in zip(neutral, ttr.dense_trace(tris, o, d, t_max)):
        assert torch.equal(g, r)
    assert not torch.equal(got[1], neutral[1])


@pytest.mark.parametrize("which", ["reduced", "full"])
def test_rows_skip_matches_plain(cuda, scenes, which):
    scene = scenes[which]
    ch = scene.data.chunks
    o, d, t_max = _rays(scene, N, 11, cuda)
    lists, _ = trw.kept_lists(trw.row_words_interval(ch, o, d, t_max), 160,
                              1000)
    skip = _skip(N, 12, cuda).to(torch.float32)
    trw.reset_launches()
    got = trw.rows_closest_walk(ch, lists, o, d, t_max, skip)
    assert torch.equal(got, trw.rows_closest_walk_plain(ch, lists, o, d,
                                                        t_max, skip=skip))
    assert trw.LAUNCHES["rows_closest_skip"] == 1
    neutral = trw.rows_closest_walk(ch, lists, o, d, t_max,
                                    torch.full_like(skip, -2.0))
    assert torch.equal(neutral, trw.rows_closest_walk(ch, lists, o, d, t_max))


@pytest.mark.parametrize("which", ["reduced", "full"])
def test_slot_skip_matches_plain(cuda, scenes, which):
    scene = scenes[which]
    ch = scene.data.chunks
    o, d, t_max = _rays(scene, N, 13, cuda)
    lists, _ = tcu.candidate_lists_2l(ch, o, d, t_max, ts.C_MAIN)
    _, slot_ray, row_chunk, valid = ts._slots(ch, lists, ts.C_MAIN, 64, None,
                                              N)
    skip = _skip(N, 14, cuda)
    stream = ts._pack_stream(o, d, t_max, slot_ray, valid, extra=skip)
    ts.reset_launches()
    got = ts.slot_closest(ch.rows, ch.leaf_size, row_chunk, stream,
                          with_skip=True)
    assert torch.equal(got, ts.slot_closest_plain(
        ch.rows, ch.leaf_size, row_chunk, stream, with_skip=True))
    assert ts.LAUNCHES["slot_closest_skip"] == 1
    neutral = ts._pack_stream(o, d, t_max, slot_ray, valid,
                              extra=torch.full_like(skip, -2))
    assert torch.equal(
        ts.slot_closest(ch.rows, ch.leaf_size, row_chunk, neutral,
                        with_skip=True),
        ts.slot_closest(ch.rows, ch.leaf_size, row_chunk, neutral))


@pytest.mark.parametrize("which", ["reduced", "full"])
def test_walker_skip_matches_plain(cuda, scenes, which):
    scene = scenes[which]
    ch = scene.data.chunks
    o, d, t_max = _rays(scene, N, 15, cuda)
    lists, _ = tw.walker_lists(ts.cross_words(ch, o, d, t_max), tw.C_WALK)
    skip = _skip(N, 16, cuda).to(torch.float32)
    tw.reset_launches()
    got = tw.walker_closest_walk(ch, lists, o, d, t_max, skip)
    ref = tw.walker_closest_plain(ch, lists, o, d, t_max, skip=skip)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert tw.LAUNCHES["walker_closest_skip"] == 1
    neutral = tw.walker_closest_walk(ch, lists, o, d, t_max,
                                     torch.full_like(skip, -2.0))
    for g, r in zip(neutral, tw.walker_closest_walk(ch, lists, o, d, t_max)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("engine", ["slot", "walker", "fallback"])
def test_dispatch_skip_matches_cpu(cuda, scenes, monkeypatch, engine):
    """intersect(skip_light=...) on the card (kernels) and on the CPU
    (plain versions), bit for bit, with bary_count; shadow-style lanes'
    .hit equals any_intersect."""
    scene = scenes["full"]
    if engine == "walker":
        monkeypatch.setattr(traverse, "WALKER_CLOSEST", True)
        monkeypatch.setattr(traverse, "WALKER_ANY", True)
    if engine == "fallback":
        monkeypatch.setattr(ts, "_max_rows", lambda *a: 0)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        data = scene.data if dev == cuda else _to_cpu(scene.data)
        o, d, t_max = (x.to(dev) for x in _rays(scene, N, 17, cuda))
        chord = torch.where(t_max > 0.0, 0.9999, 0.0)
        skip = _skip(N, 18, dev)
        skip[: N // 2] = -2
        t_c = torch.cat([t_max[: N // 2], chord[N // 2:]])
        hit = traverse.intersect(data, scene.meta, o, d, t_c, skip,
                                 skip_sort=True, bary_count=N // 2)
        occ = traverse.any_intersect(data, scene.meta, o[N // 2:],
                                     d[N // 2:], chord[N // 2:],
                                     skip[N // 2:], skip_sort=True)
        assert torch.equal(hit.hit[N // 2:], occ)
        out[dev.type] = hit
    for f in ("hit", "t", "prim", "sphere", "b0", "b1"):
        assert torch.equal(getattr(out["cuda"], f).cpu(),
                           getattr(out["cpu"], f)), f
