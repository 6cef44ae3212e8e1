"""The treelet dispatch's divergent-wave kernels (two-level cull, crossing
words, closest and occlusion slot walks) against their plain PyTorch
versions, on the card.  Marked ``cuda``: they skip where
torch.cuda.is_available() is False.  This file imports no JAX, so on the
card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_stream.py

Both sides run on the same card and must agree bit for bit: the same
tests in the same order, built with -fmad=false.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_scenes import REDUCED
from yuki_tpu_torch import traverse
from yuki_tpu_torch.ops import trace_cull as tcu
from yuki_tpu_torch.ops import trace_stream as ts
from yuki_tpu_torch.ops.trace import F32_MAX
from yuki_tpu_torch.scene.testscenes import colonnade

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _rays(scene, n, seed, dev):
    """Bounce-like rays: origins inside the scene box, random directions,
    an eighth axis-parallel from chunk-box corners, a tenth parked."""
    rng = np.random.default_rng(seed)
    lo = scene.data.world_lo.cpu().numpy()
    hi = scene.data.world_hi.cpu().numpy()
    o = (lo + rng.random((n, 3)) * (hi - lo)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    q = n // 8
    axis = rng.integers(0, 3, q)
    d[:q] = 0.0
    d[np.arange(q), axis] = rng.choice([-1.0, 1.0], q)
    cb = scene.data.chunks.treelet_bounds[:, :3].cpu().numpy()
    o[:q] = cb[rng.integers(0, cb.shape[0], q)]
    t_max = np.full(n, F32_MAX, np.float32)
    t_max[rng.random(n) < 0.1] = 0.0
    return (torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev),
            torch.as_tensor(t_max, device=dev))


@pytest.fixture(scope="module")
def scenes():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return {"reduced": colonnade(device="cuda", **REDUCED)[0],
            "full": colonnade(device="cuda")[0]}


@pytest.mark.parametrize("which", ["reduced", "full"])
def test_cross_words_match_plain(cuda, scenes, which):
    scene = scenes[which]
    ch = scene.data.chunks
    o, d, t_max = _rays(scene, 3000, 1, cuda)
    ts.reset_launches()
    got = ts.cross_words(ch, o, d, t_max)
    assert ts.LAUNCHES["cross_words"] == 1
    assert torch.equal(got, ts.cross_words_plain(ch, o, d, t_max))
    assert int(ts.popcount32(got).sum()) > 3000


@pytest.mark.parametrize("C,S", [(16, 24), (4, 3), (16, 2)])
def test_cull_matches_plain(cuda, scenes, C, S):
    scene = scenes["full"]
    ch = scene.data.chunks
    o, d, t_max = _rays(scene, 3000, 2, cuda)
    tcu.reset_launches()
    lists, ov = tcu.candidate_lists_fused(ch, o, d, t_max, C, S)
    assert tcu.LAUNCHES["cull"] == 1
    ref_l, ref_ov = tcu.candidate_lists_2l(ch, o, d, t_max, C, S)
    assert torch.equal(ov, ref_ov) and torch.equal(lists, ref_l)
    if (C, S) != (16, 24):
        assert bool(ov.any())  # forced overflow
    assert (lists[t_max == 0.0] == -1).all()


@pytest.mark.parametrize("which", ["reduced", "full"])
def test_slot_walks_match_plain(cuda, scenes, which):
    scene = scenes[which]
    ch = scene.data.chunks
    n = 4096
    o, d, t_max = _rays(scene, n, 3, cuda)
    lists, _ = tcu.candidate_lists_2l(ch, o, d, t_max, ts.C_MAIN)
    slot_pos, slot_ray, row_chunk, valid = ts._slots(ch, lists, ts.C_MAIN, 64,
                                                     None, n)
    assert not valid.all()  # chunk padding: invalid slots, t = -1
    stream = ts._pack_stream(o, d, t_max, slot_ray, valid)
    ts.reset_launches()
    got = ts.slot_closest(ch.rows, ch.leaf_size, row_chunk, stream)
    ref = ts.slot_closest_plain(ch.rows, ch.leaf_size, row_chunk, stream)
    assert torch.equal(got, ref)
    assert int((got[1] >= 0).sum()) > n // 4
    rng = np.random.default_rng(4)
    skip = torch.as_tensor(rng.choice([-2, -1, 0], n).astype(np.int32),
                           device=cuda)
    chord = torch.where(t_max > 0.0, 3.0, 0.0)
    stream = ts._pack_stream(o, d, chord, slot_ray, valid, extra=skip)
    occ = ts.slot_any(ch.rows, ch.leaf_size, row_chunk, stream)
    assert torch.equal(occ, ts.slot_any_plain(ch.rows, ch.leaf_size,
                                              row_chunk, stream))
    assert bool(occ.any())
    assert ts.LAUNCHES["slot_closest"] == 1 and ts.LAUNCHES["slot_any"] == 1


def _dispatch_both(scene, meta, n, seed, dev):
    """The whole dispatch on the card and on the CPU on the same rays."""
    out = {}
    for device in (dev, torch.device("cpu")):
        data = scene.data if device == dev else _to_cpu(scene.data)
        o, d, t_max = (x.to(device) for x in _rays(scene, n, seed, dev))
        skip = torch.full((n,), -2, dtype=torch.int32, device=device)
        hit = traverse.intersect(data, meta, o, d, t_max)
        occ = traverse.any_intersect(data, meta, o, d,
                                     torch.where(t_max > 0.0, 3.0, 0.0), skip)
        out[device.type] = (hit, occ)
    return out["cuda"], out["cpu"]


def _to_cpu(data):
    def move(x):
        if isinstance(x, torch.Tensor):
            return x.cpu()
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{
                f.name: move(getattr(x, f.name)) for f in dataclasses.fields(x)})
        return x
    return move(data)


@pytest.mark.parametrize("case", ["plain", "overflow", "fallback"])
def test_dispatch_matches_plain(cuda, scenes, monkeypatch, case):
    """The dispatch on the card (kernels) and on the CPU (plain versions):
    the slot branch through the cull, with an overflow re-run through the
    crossing words kernel (C_MAIN lowered), and a blown budget that falls
    back to the treelet walk."""
    scene = scenes["full"]
    if case == "overflow":
        monkeypatch.setattr(ts, "C_MAIN", 2)
    if case == "fallback":
        monkeypatch.setattr(ts, "_max_rows", lambda *a: 0)
    traverse.reset_counts()
    (hit_k, occ_k), (hit_p, occ_p) = _dispatch_both(scene, scene.meta, 4096,
                                                    5, cuda)
    for f in ("hit", "t", "prim", "sphere", "b0", "b1"):
        assert torch.equal(getattr(hit_k, f).cpu(), getattr(hit_p, f)), f
    assert torch.equal(occ_k.cpu(), occ_p)
    c = traverse.counts()
    assert c["closest_slot"] == 2 and c["any_slot"] == 2
    assert c["fallbacks"] == (4 if case == "fallback" else 0)
    if case == "overflow":
        assert c["wide_reruns"] == 4 and c["overflow_rays"] > 1000
