"""The row-union walks (rows_closest_walk, rows_any_walk) against their
plain PyTorch versions, on the card.  Marked ``cuda``: they skip where
torch.cuda.is_available() is False.  This file imports no JAX, so on the
card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_rows.py

Both sides run on the same card and must agree bit for bit: the same
tests in the same order, built with -fmad=false.
"""

import numpy as np
import pytest
import torch

from test_torch_cuda_stream import _to_cpu
from torch_scenes import REDUCED, row_trap
from yuki_tpu_torch import traverse
from yuki_tpu_torch.camera import Camera
from yuki_tpu_torch.ops import trace_rows as trw
from yuki_tpu_torch.ops.trace import F32_MAX
from yuki_tpu_torch.scene.testscenes import colonnade

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")


@pytest.fixture(scope="module")
def scene():
    _need_card()
    return colonnade(device="cuda", **REDUCED)


def _camera_rays(scene, w=64, h=48, axis_parallel=True):
    """The reduced colonnade's camera rays through pixel centres, in film
    order (whole 128-ray rows); with ``axis_parallel`` every ninth lane
    axis-parallel from a chunk-box corner; every seventh parked with
    t_max 0."""
    sc, cam, _ = scene
    dev = sc.data.world_lo.device
    py, px = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    p = torch.stack([px.reshape(-1), py.reshape(-1)], -1).float() + 0.5
    o, d = Camera.create(cam, w, h).ray(p)
    o, d = o.contiguous(), d.contiguous()
    n = o.shape[0]
    rng = np.random.default_rng(1)
    par = (torch.arange(n, device=dev) % 9 == 4) & axis_parallel
    m = int(par.sum())
    axis = torch.as_tensor(rng.integers(0, 3, m), device=dev)
    dpar = torch.zeros((m, 3), device=dev)
    dpar[torch.arange(m, device=dev), axis] = torch.as_tensor(
        rng.choice([-1.0, 1.0], m).astype(np.float32), device=dev)
    d[par] = dpar
    cb = sc.data.chunks.treelet_bounds
    o[par] = cb[torch.as_tensor(rng.integers(0, cb.shape[0], m), device=dev),
                :3]
    t_max = torch.full((n,), F32_MAX, device=dev)
    t_max[torch.arange(n, device=dev) % 7 == 3] = 0.0
    return o, d, t_max


@pytest.mark.parametrize("C,mult", [(160, 160), (6, 4)])
def test_rows_walks_match_plain(scene, C, mult):
    """Both walks on the probe's union words (wide: the axis-parallel lanes
    widen their rows' direction intervals); (6, 4) cuts lists and blows
    the pair budget, so rows walk shortened lists or none."""
    ch = scene[0].data.chunks
    o, d, t_max = _camera_rays(scene)
    words = trw.row_words_interval(ch, o, d, t_max)
    lists, ov = trw.kept_lists(words, C, mult)
    if C == 6:
        assert bool(ov.any()) and bool((lists[:, 0] == -1).any())
    trw.reset_launches()
    got = trw.rows_closest_walk(ch, lists, o, d, t_max)
    assert torch.equal(got, trw.rows_closest_walk_plain(ch, lists, o, d,
                                                        t_max))
    assert int((got[1] >= 0).sum()) > (o.shape[0] // 4 if C == 160 else 0)
    rng = np.random.default_rng(2)
    skip = torch.as_tensor(rng.choice([-2.0, -1.0, 0.0], o.shape[0]).astype(
        np.float32), device=o.device)
    chord = torch.where(t_max > 0.0, 30.0, 0.0)
    occ = trw.rows_any_walk(ch, lists, o, d, chord, skip)
    assert torch.equal(occ, trw.rows_any_walk_plain(ch, lists, o, d, chord,
                                                    skip))
    assert bool(occ.any()) and not bool(occ.all())
    assert trw.LAUNCHES == {"rows_closest": 1, "rows_closest_skip": 0,
                                "rows_any": 1}


def test_rows_walk_traps():
    """torch_scenes.row_trap: a lane whose recheck fails is walked with its
    row, and the occlusion walk leaves a chunk for the whole row."""
    from types import SimpleNamespace

    _need_card()
    rows, bounds, words, o, d, t_max = (torch.as_tensor(x.astype(
        np.int64) if x.dtype == np.uint32 else x, device="cuda")
        for x in row_trap())
    ch = SimpleNamespace(n_treelets=1, leaf_size=16, treelet_bounds=bounds,
                         rows=rows)
    lists, _ = trw.kept_lists(words, 4, 4)
    got = trw.rows_closest_walk(ch, lists, o, d, t_max)
    assert torch.equal(got, trw.rows_closest_walk_plain(ch, lists, o, d,
                                                        t_max))
    lanes = [0, 1, 128, 256, 257]
    assert got[1, lanes].tolist() == [1.0, 0.0, -1.0, 1.0, 1.0]
    skip = torch.full_like(t_max, -2.0)
    occ = trw.rows_any_walk(ch, lists, o, d, t_max, skip)
    assert torch.equal(occ, trw.rows_any_walk_plain(ch, lists, o, d, t_max,
                                                    skip))
    assert occ[lanes].tolist() == [0, 1, 0, 1, 1]


def test_rows_dispatch_matches_cpu(scene):
    """The whole dispatch on a coherent wave: rows branch on the card and
    on the CPU, equal."""
    sc = scene[0]
    o, d, t_max = _camera_rays(scene, axis_parallel=False)
    out = []
    for dev in ("cuda", "cpu"):
        data = sc.data if dev == "cuda" else _to_cpu(sc.data)
        traverse.reset_counts()
        hit = traverse.intersect(data, sc.meta, o.to(dev), d.to(dev),
                                 t_max.to(dev))
        assert traverse.counts()["closest_rows"] == 1
        out.append([x.cpu() for x in hit])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_rows_wrappers_validate(scene):
    ch = scene[0].data.chunks
    o, d, t_max = _camera_rays(scene)
    lists, _ = trw.kept_lists(trw.row_words_interval(ch, o, d, t_max), 16, 8)
    with pytest.raises(ValueError, match="128-ray rows"):
        trw.rows_closest_walk(ch, lists, o[:100], d[:100], t_max[:100])
    with pytest.raises(ValueError, match="dtype"):
        trw.rows_closest_walk(ch, lists.long(), o, d, t_max)
    with pytest.raises(ValueError, match="skip"):
        trw.rows_any_walk(ch, lists, o, d, t_max,
                          torch.zeros(o.shape[0], dtype=torch.int32,
                                      device=o.device))
