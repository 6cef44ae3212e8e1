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
from yuki_tpu_torch.treelets import TreeletArrays

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


CULL_CASES = [pytest.param(C, S, "random", id=f"{C}-{S}")
              for C, S in ((16, 24), (4, 3), (16, 2))] + [
    pytest.param(16, 24, "sorted", id="16-24-sorted"),
    pytest.param(16, 24, "overflow", id="16-24-overflow-heavy"),
    pytest.param(16, 24, "ragged", id="16-24-ragged"),
]


@pytest.mark.parametrize("C,S,rays", CULL_CASES)
def test_cull_matches_plain(cuda, scenes, C, S, rays):
    """Random bounce-like rays (forced overflow with small C and S); the
    same rays sorted by traverse.ray_sort_key; an overflow-heavy set
    (from chunk centres, nearly along the scene's long axis: about 28%
    overflow); and a ragged count (no multiple of a warp or of the
    kernel's block)."""
    scene = scenes["full"]
    ch = scene.data.chunks
    n = {"ragged": 3000 + 23 * 32 + 5}.get(rays, 3000)
    o, d, t_max = _rays(scene, n, 2, cuda)
    if rays == "sorted":
        order = torch.argsort(traverse.ray_sort_key(scene.data, o, d),
                              stable=True)
        o, d, t_max = (x[order].contiguous() for x in (o, d, t_max))
    if rays == "overflow":  # from chunk centres, nearly along the long axis
        cb = ch.treelet_bounds
        k = torch.as_tensor(np.random.default_rng(2).integers(
            0, cb.shape[0], n), device=cuda)
        o = (0.5 * (cb[k, :3] + cb[k, 3:6])).contiguous()
        ax = int(torch.argmax(scene.data.world_hi - scene.data.world_lo))
        d = d.clone()
        d[:, ax] = torch.where(d[:, ax] >= 0.0, 20.0, -20.0)
        d = (d / d.norm(dim=1, keepdim=True)).contiguous()
    tcu.reset_launches()
    lists, ov = tcu.candidate_lists_fused(ch, o, d, t_max, C, S)
    assert tcu.LAUNCHES["cull"] == 1
    ref_l, ref_ov = tcu.candidate_lists_2l(ch, o, d, t_max, C, S)
    assert torch.equal(ov, ref_ov) and torch.equal(lists, ref_l)
    if (C, S) != (16, 24):
        assert bool(ov.any())  # forced overflow
    if rays == "overflow":
        assert int(ov.sum()) > n // 10
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


# ---- the redesigned crossing words and closest slot walk at edge shapes


def _sub_chunks(ch, m):
    """The first m chunks of ``ch`` as a chunk structure of their own."""
    k = ch.leaf_size
    return TreeletArrays(
        super_bounds=ch.treelet_bounds[:m], super_range=ch.super_range[:m],
        treelet_bounds=ch.treelet_bounds[:m].contiguous(),
        rows=ch.rows[:m * k].contiguous(), leaf_size=k, n_supers=m,
        n_treelets=m)


def _edge_rays(scene, n, seed, dev, dead=False):
    """_rays plus the crossing words' edge cases: a quarter with t_max =
    +inf, among them rays with no negative direction component (the +inf
    pad chunks cross those) and axis-parallel rays with -0.0 components."""
    o, d, t_max = _rays(scene, n, seed, dev)
    rng = np.random.default_rng(seed + 100)
    inf = torch.as_tensor(rng.random(n) < 0.25, device=dev)
    t_max = torch.where(inf & (t_max > 0.0), float("inf"), t_max)
    pos = torch.as_tensor(rng.random(n) < 0.3, device=dev)
    d = torch.where(pos[:, None], d.abs(), d)
    d = torch.where(d == 0.0, torch.where(pos[:, None], -0.0, 0.0), d)
    if dead:
        t_max = torch.where(torch.arange(n, device=dev) % 2 == 0, 0.0, -1.0)
    return o.contiguous(), d.contiguous(), t_max.contiguous()


@pytest.mark.parametrize("n_chunks", [31, 32, 33, None])
@pytest.mark.parametrize("n", [1, 31, 33, 2217, "dead"])
def test_cross_words_edge_shapes(cuda, scenes, n_chunks, n):
    """Waves of 1, 31, 33 and 2,217 rays and a wave with every ray dead,
    on the first 31, 32 and 33 chunks of the colonnade and on all of
    them: the kernel's words equal the plain version's bit for bit."""
    scene = scenes["full"]
    ch = scene.data.chunks
    if n_chunks is not None:
        ch = _sub_chunks(ch, n_chunks)
    m = 64 if n == "dead" else n
    o, d, t_max = _edge_rays(scene, m, 7, cuda, dead=n == "dead")
    ts.reset_launches()
    got = ts.cross_words(ch, o, d, t_max)
    assert ts.LAUNCHES["cross_words"] == 1
    ref = ts.cross_words_plain(ch, o, d, t_max)
    assert torch.equal(got, ref)
    if n == "dead":
        assert not bool(got.any())


def test_cross_words_pad_chunks_cross_like_the_plain_version(cuda, scenes):
    """Rays with t_max = +inf and no negative direction component cross
    the +inf pad chunks of a partial last word, in the plain version as in
    yuki_tpu; the kernel gives the same bits."""
    ch = _sub_chunks(scenes["full"].data.chunks, 33)
    n = 64
    o = torch.zeros((n, 3), device=cuda)
    d = torch.rand((n, 3), device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(3))
    d[:8] = torch.tensor([0.0, -0.0, 1.0], device=cuda)
    t_max = torch.full((n,), float("inf"), device=cuda)
    got = ts.cross_words(ch, o, d, t_max)
    ref = ts.cross_words_plain(ch, o, d, t_max)
    assert torch.equal(got, ref)
    assert bool(((got[:, 1] >> 1) != 0).all())  # bits past chunk 32


def _synthetic_chunks(k, n_chunks, seed, dev):
    """Chunks of k random triangle rows in [-1, 1]^3: chunk 0 all real,
    chunk 1 all padding but row 0, chunk 2 padding between real rows
    (not a tail), the rest a random real count then padding (prim id -1,
    light -3); light ids among -1, 0 and 1."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n_chunks * k, 12), np.float32)
    rows[:, 0:9] = rng.uniform(-1.0, 1.0, (n_chunks * k, 9))
    rows[:, 9] = rng.choice([-1.0, 0.0, 1.0], n_chunks * k)
    rows[:, 10] = np.arange(n_chunks * k)
    real = rng.integers(1, k + 1, n_chunks)
    real[0], real[1] = k, 1
    pad = np.arange(k)[None, :] >= real[:, None]
    pad[2] = rng.random(k) < 0.5
    pad[2, [0, k - 1]] = False, True
    pad = pad.reshape(-1)
    rows[pad, 9] = -3.0
    rows[pad, 10] = -1.0
    return torch.as_tensor(rows, device=dev)


def _slot_stream(n_rows, n_chunks, seed, dev):
    """Slot rows (row_chunk, stream): rays from [-0.3, 0.3]^3 at random
    directions, skip ids among -2, 0 and 1; row 0 has no live slot, row 1
    one, row 2 all, the rest about a third dead (t -1 or 0)."""
    rng = np.random.default_rng(seed)
    n = n_rows * 128
    st = np.zeros((n, 8), np.float32)
    st[:, 0:3] = rng.uniform(-0.3, 0.3, (n, 3))
    dr = rng.standard_normal((n, 3))
    st[:, 3:6] = dr / np.linalg.norm(dr, axis=1, keepdims=True)
    st[:, 6] = np.where(rng.random(n) < 0.5, 3.0e38, rng.uniform(0.5, 4.0, n))
    live = rng.random(n) > 0.3
    live[:128] = False
    live[128:256] = np.arange(128) == 77
    live[256:384] = True
    st[~live, 6] = rng.choice([-1.0, 0.0], int((~live).sum()))
    st[:, 7] = rng.choice([-2.0, 0.0, 1.0], n)
    row_chunk = rng.integers(0, n_chunks, n_rows).astype(np.int32)
    row_chunk[:4] = [0, 1, 2, 0]
    return (torch.as_tensor(row_chunk, device=dev),
            torch.as_tensor(st, device=dev))


@pytest.mark.parametrize("with_skip", [False, True])
@pytest.mark.parametrize("k", [8, 64, 128, 256])
def test_slot_closest_edge_shapes(cuda, k, with_skip):
    """Leaf sizes 8 to 256, rows with no, one and all slots live, chunks
    whose padding is not a tail, with and without skip: the kernel equals
    the plain version bit for bit, and slots permuted within their rows
    give the permuted outputs."""
    n_chunks, n_rows = 7, 24
    rows = _synthetic_chunks(k, n_chunks, k, cuda)
    row_chunk, stream = _slot_stream(n_rows, n_chunks, k + 1, cuda)
    name = "slot_closest_skip" if with_skip else "slot_closest"
    ts.reset_launches()
    got = ts.slot_closest(rows, k, row_chunk, stream, with_skip)
    assert ts.LAUNCHES[name] == 1
    ref = ts.slot_closest_plain(rows, k, row_chunk, stream,
                                with_skip=with_skip)
    assert torch.equal(got, ref)
    assert int((got[1] >= 0).sum()) > n_rows * 16
    perm = torch.argsort(torch.rand((n_rows, 128), device=cuda,
                                    generator=torch.Generator(device=cuda)
                                    .manual_seed(k)), dim=1)
    perm = (perm + 128 * torch.arange(n_rows, device=cuda)[:, None]
            ).reshape(-1)
    got_p = ts.slot_closest(rows, k, row_chunk, stream[perm].contiguous(),
                            with_skip)
    assert torch.equal(got_p, got[:, perm])


@pytest.mark.parametrize("k", [8, 64, 128, 256])
def test_slot_any_edge_shapes(cuda, k):
    """Leaf sizes 8 to 256: a chunk whose last real row is row k - 1, one
    with padding between real rows, rows with no live slot and warps with
    none, and a chunk whose one real triangle carries light id 1 in front
    of every slot of its row, which occludes the slots that skip another
    light and not those that skip light 1.  The occlusion walk equals the
    plain version bit for bit, and slots permuted within their rows give
    the permuted occlusion."""
    n_chunks, n_rows = 7, 24
    rows = _synthetic_chunks(k, n_chunks, k, cuda)
    row_chunk, stream = _slot_stream(n_rows, n_chunks, k + 1, cuda)
    # Chunk n_chunks: row 0 a triangle across z = 0 with light id 1, the
    # rest padding; slot row n_rows looks at it from z = -1, half its
    # slots skipping light 1.
    own = torch.zeros((k, 12), device=cuda)
    own[:, 9], own[:, 10] = -3.0, -1.0
    own[0, 0:9] = torch.tensor([-2.0, -2.0, 0.0, 4.0, -2.0, 0.0, -2.0, 4.0,
                                0.0], device=cuda)
    own[0, 9], own[0, 10] = 1.0, 5000.0
    rng = np.random.default_rng(k)
    extra = np.zeros((128, 8), np.float32)
    extra[:, 0:2] = rng.uniform(-0.5, 0.5, (128, 2))
    extra[:, 2] = -1.0
    extra[:, 5] = 1.0
    extra[:, 6] = 2.0
    extra[:, 7] = np.where(np.arange(128) % 2 == 0, 1.0, -2.0)
    rows = torch.cat([rows, own])
    row_chunk = torch.cat([row_chunk, torch.tensor([n_chunks], dtype=torch.int32,
                                                   device=cuda)])
    stream = torch.cat([stream, torch.as_tensor(extra, device=cuda)])
    ts.reset_launches()
    got = ts.slot_any(rows, k, row_chunk, stream)
    assert ts.LAUNCHES["slot_any"] == 1
    ref = ts.slot_any_plain(rows, k, row_chunk, stream)
    assert torch.equal(got, ref)
    assert int(got[:128].sum()) == 0
    assert int(got[:n_rows * 128].sum()) > n_rows * 16
    own_row = got[n_rows * 128:].cpu().numpy()
    assert (own_row == np.arange(128) % 2).all()
    perm = torch.argsort(torch.rand((n_rows + 1, 128), device=cuda,
                                    generator=torch.Generator(device=cuda)
                                    .manual_seed(k)), dim=1)
    perm = (perm + 128 * torch.arange(n_rows + 1, device=cuda)[:, None]
            ).reshape(-1)
    got_p = ts.slot_any(rows, k, row_chunk, stream[perm].contiguous())
    assert torch.equal(got_p, got[perm])
