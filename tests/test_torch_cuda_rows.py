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
from test_torch_rows_any_redesign import hand_built
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


@pytest.fixture(scope="module")
def leaf_chunks(scene):
    """The reduced colonnade cut into flat chunks of 8, 128 and 256
    triangle rows ({leaf size: chunks}), as the scene builder cuts its
    128-row chunks."""
    from yuki_tpu_torch.treelets import build_treelets

    sc = scene[0]
    tris = sc.data.tris
    tri_p = torch.stack([tris.p0, tris.p1, tris.p2], dim=1).cpu().numpy()
    light = tris.area_light.cpu().numpy()
    return {k: build_treelets(sc.bvh_host, tri_p, light, leaf_size=k,
                              super_size=k, device="cuda")
            for k in (8, 128, 256)}


def _shuffled(ch, seed):
    """ch with each chunk's rows in a seeded order, so that its padding
    rows sit between real ones (not a tail)."""
    import dataclasses

    k = ch.leaf_size
    g = torch.Generator().manual_seed(seed)
    perm = torch.argsort(torch.rand((ch.n_treelets, k), generator=g), dim=1)
    rows = ch.rows.reshape(-1, k, 12)
    idx = perm.to(rows.device)[:, :, None].expand(-1, -1, 12)
    return dataclasses.replace(ch, rows=torch.gather(rows, 1, idx).reshape(
        -1, 12).contiguous())


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("case", ["k8", "k128", "k256", "k128-shuffled",
                                  "dead-rows", "one-entry",
                                  "one-entry-axis"])
def test_rows_closest_edge_shapes(scene, leaf_chunks, case, skip):
    """rows_closest_walk against its plain version, with and without skip,
    at leaf sizes 8, 128 and 256 (at 8 some rows' lists are cut at 160
    entries), on chunks whose padding is not a tail, on rows whose lanes
    are all dead (t_max 0, -1 or NaN) beside rows with dead warps, and on
    lists of one entry (each row's last).  Axis-parallel lanes make their
    rows list every chunk, whose last alone may take no hit, so
    "one-entry-axis", the one case with such lanes, holds the bits
    alone."""
    k = int(case.split("-")[0][1:]) if case.startswith("k") else 128
    ch = leaf_chunks[k]
    if case.endswith("shuffled"):
        ch = _shuffled(ch, 5)
        pid = ch.rows[:, 10].reshape(-1, k)
        last = torch.where(pid >= 0.0, torch.arange(1, k + 1,
                                                    device=pid.device), 0)
        assert bool((last.amax(dim=1) > (pid >= 0.0).sum(dim=1)).any())
    o, d, t_max = _camera_rays(scene, axis_parallel=case != "one-entry")
    n = o.shape[0]
    if case == "dead-rows":
        lane = torch.arange(n, device=o.device)
        row = lane // 128
        t_max = torch.where(row % 3 == 0, torch.tensor(
            [0.0, -1.0, float("nan")], device=o.device)[lane % 3], t_max)
        t_max = torch.where((row % 3 == 1) & (lane % 128 < 64), 0.0, t_max)
    lists, _ = trw.kept_lists(trw.row_words_interval(ch, o, d, t_max), 160,
                              160)
    if case.startswith("one-entry"):  # each row's last listed chunk alone
        last = lists[torch.arange(lists.shape[0], device=o.device),
                     (lists >= 0).sum(dim=1) - 1]
        lists[:, 1:] = -1
        lists[:, 0] = last
    if case == "k8":
        assert bool((lists[:, -1] >= 0).any())
    sk = None
    if skip:
        rng = np.random.default_rng(3)
        sk = torch.as_tensor(rng.choice([-2.0, -1.0, 0.0], n).astype(
            np.float32), device=o.device)
    trw.reset_launches()
    got = trw.rows_closest_walk(ch, lists, o, d, t_max, sk)
    ref = trw.rows_closest_walk_plain(ch, lists, o, d, t_max, skip=sk)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    if case != "one-entry-axis":
        assert int((got[1] >= 0).sum()) > 0
    if case == "dead-rows":
        dead = ~(t_max > 0.0)
        assert bool((got[1][dead] == -1.0).all())
    name = "rows_closest_skip" if skip else "rows_closest"
    assert trw.LAUNCHES[name] == 1


@pytest.mark.parametrize("perm", [(0, 1, 2), (1, 2, 0), (2, 0, 1)],
                         ids=["z", "x", "y"])
@pytest.mark.parametrize("k", [8, 64, 128])
def test_rows_any_hand_built(k, perm):
    """rows_any_walk against its plain version, bit for bit, on the rows
    of test_torch_rows_any_redesign.hand_built: a non-crossing lane whose
    occluder lies in the row's exit group G and one whose occluder lies in
    G + 1, S all occluded in group 0, lanes occluded by an earlier chunk,
    an S emptied by earlier chunks, dead lanes at t_max 0, -1 and NaN,
    padding rows between real ones and a skip id that matches the
    occluder, at leaf sizes 8, 64 and 128 with rays along z, x and y."""
    _need_card()
    ch, lists, o, d, t_max, skip, want = hand_built(k, list(perm))
    ch.treelet_bounds = ch.treelet_bounds.cuda()
    ch.rows = ch.rows.cuda()
    args = [x.cuda() for x in (lists, o, d, t_max)]
    trw.reset_launches()
    got = trw.rows_any_walk(ch, *args, skip.cuda())
    assert trw.LAUNCHES["rows_any"] == 1
    ref = trw.rows_any_walk_plain(ch, *args, skip.cuda())
    assert torch.equal(got, ref)
    for (row, lane), occ in want.items():
        assert int(got[128 * row + lane]) == occ, (row, lane)


@pytest.mark.parametrize("case", ["k8", "k128", "k256", "k128-shuffled",
                                  "dead-rows", "one-entry"])
def test_rows_any_edge_shapes(scene, leaf_chunks, case):
    """rows_any_walk against its plain version at leaf sizes 8, 128 and
    256, on chunks whose padding is not a tail, on rows whose lanes are
    all dead (t_max 0, -1 or NaN) beside rows with dead warps, and on lists
    of one entry; t_max a chord that leaves some lanes unoccluded, skip ids
    that match no light, every triangle's (-1) and light 0's."""
    k = int(case.split("-")[0][1:]) if case.startswith("k") else 128
    ch = leaf_chunks[k]
    if case.endswith("shuffled"):
        ch = _shuffled(ch, 7)
    o, d, t_max = _camera_rays(scene, axis_parallel=case != "one-entry")
    n = o.shape[0]
    t_max = torch.where(t_max > 0.0, 30.0, t_max)
    if case == "dead-rows":
        lane = torch.arange(n, device=o.device)
        row = lane // 128
        t_max = torch.where(row % 3 == 0, torch.tensor(
            [0.0, -1.0, float("nan")], device=o.device)[lane % 3], t_max)
        t_max = torch.where((row % 3 == 1) & (lane % 128 < 64), 0.0, t_max)
    lists, _ = trw.kept_lists(trw.row_words_interval(ch, o, d, t_max), 160,
                              160)
    if case == "one-entry":
        last = lists[torch.arange(lists.shape[0], device=o.device),
                     (lists >= 0).sum(dim=1) - 1]
        lists[:, 1:] = -1
        lists[:, 0] = last
    rng = np.random.default_rng(4)
    skip = torch.as_tensor(rng.choice([-2.0, -1.0, 0.0], n, p=[
        0.8, 0.1, 0.1]).astype(np.float32), device=o.device)
    trw.reset_launches()
    got = trw.rows_any_walk(ch, lists, o, d, t_max, skip)
    ref = trw.rows_any_walk_plain(ch, lists, o, d, t_max, skip)
    assert torch.equal(got, ref)
    assert trw.LAUNCHES["rows_any"] == 1
    live = t_max > 0.0
    assert 0 < int(got[live].sum()) < int(live.sum())
    assert int(got[~live].sum()) == 0


def test_rows_any_forced_shadow_wave(scene):
    """The reduced colonnade's bounce-0 shadow rays (path_li's shading of
    its camera rays, light-major, as chip_smoke.py's phase 8a makes them at
    full size) forced through the rows engine: bit for bit."""
    from yuki_tpu_torch.integrators import PathParams, _ph_i32
    from yuki_tpu_torch.ops import shade_fused as tsf
    from yuki_tpu_torch.sampling import SampleCtx

    sc, cam, _ = scene
    dev = sc.data.world_lo.device
    w, h = 128, 96
    py, px = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.int32),
                            torch.arange(w, device=dev, dtype=torch.int32),
                            indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    ctx = SampleCtx(px=px, py=py, sample_index=0, seed=1)
    o, d = Camera.create(cam, w, h).ray(
        torch.stack([px.float(), py.float()], -1) + 0.5)
    o, d = o.contiguous(), d.contiguous()
    t_max = torch.full((o.shape[0],), F32_MAX, device=dev)
    hit = traverse.intersect(sc.data, sc.meta, o, d, t_max, skip_sort=True)
    out0 = tsf.shade_fused(tsf.make_shade_tables(sc, PathParams(5)), hit, o,
                           d, torch.ones_like(o), hit.hit,
                           torch.zeros_like(hit.hit), _ph_i32(ctx), 2, 0)
    no, nd, nt, sk = out0[5:9]
    ch = sc.data.chunks
    lists, _ = trw.kept_lists(trw.row_words_interval(ch, no, nd, nt),
                              traverse._ROWS_C, traverse._ROWS_MULT)
    skf = sk.to(torch.float32).contiguous()
    got = trw.rows_any_walk(ch, lists, no, nd, nt, skf)
    ref = trw.rows_any_walk_plain(ch, lists, no, nd, nt, skf)
    assert torch.equal(got, ref)
    live = nt > 0.0
    assert 0 < int(got.sum()) < int(live.sum())
