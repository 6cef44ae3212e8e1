"""The bundle walks (walker_closest_walk, walker_any_walk) against their
plain PyTorch versions, on the card, and the dispatch with the walker
flags on the card against the CPU.  Marked ``cuda``: they skip where
torch.cuda.is_available() is False.  This file imports no JAX, so on the
card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_walker.py

Both sides run on the same card and must agree bit for bit: the same
tests, the same per-slot carry and the same fold, built with -fmad=false.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_cuda_stream import (_dispatch_both, _rays, cuda,
                                    scenes)  # noqa: F401
from yuki_tpu_torch import traverse
from yuki_tpu_torch.ops import trace_stream as ts
from yuki_tpu_torch.ops import trace_walker as tw
from yuki_tpu_torch.ops.trace import F32_MAX

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


@pytest.mark.parametrize("which,C", [("reduced", 64), ("full", 64),
                                     ("full", 4)])
def test_walks_match_plain(cuda, scenes, which, C):
    """Bounce-like rays (axis-parallel and parked lanes among them); C = 4
    cuts the lists, so the walks take shortened lists."""
    scene = scenes[which]
    ch = scene.data.chunks
    n = 4096
    o, d, t_max = _rays(scene, n, 6, cuda)
    lists, ov = tw.walker_lists(ts.cross_words(ch, o, d, t_max), C)
    if C == 4:
        assert bool(ov.any())
    tw.reset_launches()
    got = tw.walker_closest_walk(ch, lists, o, d, t_max)
    ref = tw.walker_closest_plain(ch, lists, o, d, t_max)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert int((got[1] >= 0).sum()) > n // 4
    rng = np.random.default_rng(7)
    skip = torch.as_tensor(rng.choice([-2.0, -1.0, 0.0], n).astype(
        np.float32), device=cuda)
    chord = torch.where(t_max > 0.0, 3.0, 0.0)
    occ = tw.walker_any_walk(ch, lists, o, d, chord, skip)
    assert torch.equal(occ, tw.walker_any_plain(ch, lists, o, d, chord, skip))
    assert bool(occ.any()) and not bool(occ.all())
    assert tw.LAUNCHES == {"walker_closest": 1, "walker_closest_skip": 0,
                               "walker_any": 1}


def test_walker_ties(cuda):
    """Two 8-triangle chunks under one box: the same triangle in chunk 0
    slots 1 (prim 5) and 3 (prim 2) and chunk 1 slot 1 (prim 1).  Slot 1
    keeps the first in list order (prim 5), the fold takes the lower prim
    of slots 1 and 3: prim 2 (a running minimum would give 1)."""
    k = 8
    rows = np.zeros((2 * k, 12), np.float32)
    rows[:, 9:11] = -1.0
    for row, prim in ((1, 5), (3, 2), (k + 1, 1)):
        rows[row, :9] = [0.0, 0.0, 0.5, 1.0, 0.0, 0.5, 0.0, 1.0, 0.5]
        rows[row, 10] = prim
    bounds = np.tile(np.array([[0, 0, 0, 1, 1, 1, 0, 0]], np.float32), (2, 1))
    ch = SimpleNamespace(n_treelets=2, leaf_size=k,
                         treelet_bounds=torch.as_tensor(bounds, device=cuda),
                         rows=torch.as_tensor(rows, device=cuda))
    o = torch.zeros((16, 3), device=cuda)
    o[:8, 0] = 0.3 + 0.04 * torch.arange(8, device=cuda)
    o[:8, 1] = 0.3
    o[:8, 2] = -1.0
    d = torch.tensor([[0.0, 0.0, 1.0]], device=cuda).repeat(16, 1)
    t_max = torch.zeros(16, device=cuda)
    t_max[:8] = F32_MAX
    lists = torch.full((2, 4), -1, dtype=torch.int32, device=cuda)
    lists[0, :2] = torch.tensor([0, 1])
    got = tw.walker_closest_walk(ch, lists, o, d, t_max)
    ref = tw.walker_closest_plain(ch, lists, o, d, t_max)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert got[1].tolist() == [2] * 8 + [-1] * 8


@pytest.mark.parametrize("case", ["plain", "overflow"])
def test_walker_dispatch_matches_plain(cuda, scenes, monkeypatch, case):
    """The dispatch with both walker flags on the card (kernels) and on the
    CPU (plain versions): the walker branch, with an overflow re-run
    through the wide pass where the lists are cut at C = 2."""
    scene = scenes["full"]
    monkeypatch.setattr(traverse, "WALKER_CLOSEST", True)
    monkeypatch.setattr(traverse, "WALKER_ANY", True)
    if case == "overflow":
        for q in ("closest", "any"):
            name = f"walker_{q}_w"
            fn = getattr(tw, name)
            monkeypatch.setattr(traverse, name,
                                lambda *a, _fn=fn, **k: _fn(*a, **k, C=2))
    traverse.reset_counts()
    (hit_k, occ_k), (hit_p, occ_p) = _dispatch_both(scene, scene.meta, 4096,
                                                    5, cuda)
    for f in ("hit", "t", "prim", "sphere", "b0", "b1"):
        assert torch.equal(getattr(hit_k, f).cpu(), getattr(hit_p, f)), f
    assert torch.equal(occ_k.cpu(), occ_p)
    c = traverse.counts()
    assert c["closest_walker"] == 2 and c["any_walker"] == 2
    assert c["closest_slot"] == 0 and c["any_slot"] == 0
    assert c["fallbacks"] == 0
    if case == "overflow":
        assert c["wide_reruns"] == 4 and c["overflow_rays"] > 4096


def test_walker_wrappers_validate(cuda, scenes):
    ch = scenes["reduced"].data.chunks
    o, d, t_max = _rays(scenes["reduced"], 64, 8, cuda)
    lists, _ = tw.walker_lists(ts.cross_words(ch, o, d, t_max), 8)
    with pytest.raises(ValueError, match="bundles"):
        tw.walker_closest_walk(ch, lists, o[:60], d[:60], t_max[:60])
    with pytest.raises(ValueError, match="dtype"):
        tw.walker_closest_walk(ch, lists.long(), o, d, t_max)
    with pytest.raises(ValueError, match="skip"):
        tw.walker_any_walk(ch, lists, o, d, t_max,
                           torch.zeros(64, dtype=torch.int32, device=cuda))
