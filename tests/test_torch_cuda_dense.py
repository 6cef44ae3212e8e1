"""The dense sweeps (dense_trace, any_trace) against their plain PyTorch
versions, on the card, at 36 triangles, 1500 and 4096 (DENSE_TRI_THRESHOLD,
four shared-memory tiles).  Marked ``cuda``: they skip where
torch.cuda.is_available() is False.  This file imports no JAX, so on the
card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_dense.py

Both sides run on the same card and must agree bit for bit.
"""

import numpy as np
import pytest
import torch

from yuki_tpu_torch.ops import trace as ttr
from yuki_tpu_torch.ops.trace import F32_MAX

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def soup_inputs(n_tris, n, seed, dev):
    """A triangle soup [T, 12] in [-3, 3]^3 with light ids -1, 0, 1, and n
    rays: half at a triangle's centroid, the rest random, an eighth of
    those axis-parallel from a corner; a seventh parked with t_max 0, a
    fifth with a finite chord; skip ids -2, 0, 1."""
    rng = np.random.default_rng(seed)
    base = (rng.random((n_tris, 1, 3)) - 0.5) * 6
    tri = (base + rng.standard_normal((n_tris, 3, 3)) * 0.25).astype(np.float32)
    packed = np.zeros((n_tris, 12), np.float32)
    packed[:, :9] = tri.reshape(n_tris, 9)
    light = rng.choice([-1, -1, 0, 1], n_tris).astype(np.int32)
    o = ((rng.random((n, 3)) - 0.5) * 6).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    aim = np.arange(n) % 2 == 1
    d[aim] = tri.mean(axis=1)[rng.integers(0, n_tris, aim.sum())] - o[aim]
    par = np.arange(n) % 16 == 0
    d[par] = 0.0
    d[par, rng.integers(0, 3, par.sum())] = rng.choice([-1.0, 1.0], par.sum())
    o[par] = tri[rng.integers(0, n_tris, par.sum()), 0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(n, F32_MAX, np.float32)
    t_max[rng.random(n) < 0.2] = 2.0
    t_max[np.arange(n) % 7 == 3] = 0.0
    skip = rng.choice([-2, 0, 1], n).astype(np.int32)
    return [torch.as_tensor(x, device=dev) for x in
            (packed, light, o, d, t_max, skip)]


@pytest.mark.parametrize("n_tris", [36, 1500, 4096])
def test_dense_sweeps_match_plain(cuda, n_tris):
    packed, light, o, d, t_max, skip = soup_inputs(n_tris, 3000, n_tris, cuda)
    ttr.reset_launches()
    got = ttr.dense_trace(packed, o, d, t_max)
    ref = ttr.dense_trace_plain(packed, o, d, t_max)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert int((got[1] >= 0).sum()) > 3000 // 4
    occ = ttr.any_trace(packed, light, o, d, t_max, skip)
    assert torch.equal(occ, ttr.any_trace_plain(packed, light, o, d, t_max,
                                                skip))
    assert bool(occ.any()) and not bool(occ.all())
    assert ttr.LAUNCHES == {"dense_closest": 1, "dense_closest_skip": 0,
                                "dense_any": 1}


def test_dense_wrappers_validate(cuda):
    packed, light, o, d, t_max, skip = soup_inputs(36, 256, 1, cuda)
    with pytest.raises(ValueError, match="dtype"):
        ttr.dense_trace(packed.double(), o, d, t_max)
    with pytest.raises(ValueError, match="skip_light"):
        ttr.any_trace(packed, light, o, d, t_max, skip.float())
    with pytest.raises(ValueError, match="tri_light"):
        ttr.any_trace(packed, light[:10], o, d, t_max, skip)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("n_tris", [1, 36, 1024, 1025, 4096])
def test_dense_closest_edge_shapes(cuda, n_tris, skip):
    """dense_trace (and dense_trace_skip) against its plain version on 3001
    rays (not a multiple of the block) from random origins in every
    direction, so that blocks hold all three shear frames, at 1 to 4096
    triangles (one, several and a ragged last shared-memory tile); every
    fifth triangle (and its light id) a copy of the one before, so exact
    ties go to the lower index."""
    packed, light, o, d, t_max, sk = soup_inputs(n_tris, 3001, 7 + n_tris,
                                                 cuda)
    packed[5::5] = packed[4:-1:5]
    light[5::5] = light[4:-1:5]
    ad = d.abs()
    x_max = (ad[:, 0] > ad[:, 1]) & (ad[:, 0] > ad[:, 2])
    y_max = ~x_max & (ad[:, 1] > ad[:, 2])
    assert min(int(x_max.sum()), int(y_max.sum()),
               int((~x_max & ~y_max).sum())) > 3001 // 5
    ttr.reset_launches()
    if skip:
        got = ttr.dense_trace_skip(packed, light, o, d, t_max, sk)
        ref = ttr.dense_trace_skip_plain(packed, light, o, d, t_max, sk)
    else:
        got = ttr.dense_trace(packed, o, d, t_max)
        ref = ttr.dense_trace_plain(packed, o, d, t_max)
    for g, r in zip(got, ref):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))
    assert int((got[1] >= 0).sum()) > 0
    if n_tris >= 36:
        assert int(((got[1] % 5 == 4) & (got[1] >= 0)).sum()) > 0
        assert int((got[1] % 5 == 0)[got[1] > 0].sum()) == 0
    name = "dense_closest_skip" if skip else "dense_closest"
    assert ttr.LAUNCHES[name] == 1


@pytest.mark.parametrize("case", ["rays", "one-ray", "all-dead",
                                  "all-at-first", "nan-t-max"])
@pytest.mark.parametrize("n_tris", [1, 36, 4096])
def test_dense_any_edge_shapes(cuda, n_tris, case):
    """any_trace against its plain version bit for bit on 3001 rays (not
    a multiple of the block) in every direction, or one ray, at 1, 36 and
    4096 triangles (one, one and sixteen shared-memory tiles): as made;
    every lane dead (t_max 0 or -1); every lane aimed at triangle 0's
    centroid, so occluded at the first test; a third of the lanes with a
    NaN t_max, which misses no range compare and stays live."""
    n = 1 if case == "one-ray" else 3001
    packed, light, o, d, t_max, skip = soup_inputs(n_tris, n, 11 + n_tris,
                                                   cuda)
    if case == "all-dead":
        t_max[:] = 0.0
        t_max[::2] = -1.0
    elif case == "all-at-first":
        light[0] = -1
        c = packed[0, :9].reshape(3, 3).mean(dim=0)
        d = torch.nn.functional.normalize(torch.randn(
            (n, 3), generator=torch.Generator().manual_seed(n_tris)).to(cuda),
            dim=1)
        o = (c - 3.0 * d).contiguous()
        t_max = torch.full((n,), F32_MAX, device=cuda)
    elif case == "nan-t-max":
        t_max[::3] = float("nan")
    ttr.reset_launches()
    got = ttr.any_trace(packed, light, o, d, t_max, skip)
    ref = ttr.any_trace_plain(packed, light, o, d, t_max, skip)
    assert torch.equal(got, ref)
    assert ttr.LAUNCHES["dense_any"] == 1
    if case == "all-dead":
        assert not bool(got.any())
    elif case == "all-at-first":
        assert bool(got.all())
    elif case == "nan-t-max" and n_tris >= 36:
        assert bool(got[::3].any()) and not bool(got[::3].all())
    elif case == "rays" and n_tris >= 36:
        assert bool(got.any()) and not bool(got.all())
