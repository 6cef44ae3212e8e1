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
