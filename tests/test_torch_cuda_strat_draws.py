"""The stratified sampler's draws kernel (``ops/strat_draws``,
``ops/csrc/sampling.cu``) on the card, bit for bit against the torch
route.  Marked ``cuda``: they skip where torch.cuda.is_available() is
False.  This file imports no JAX, so on the card it runs without the
repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_strat_draws.py
"""

import numpy as np
import pytest
import torch

from test_torch_cuda import DEPTH, _setup, cuda  # noqa: F401
from yuki_tpu_torch import profiling
from yuki_tpu_torch.ops import path_fused as tpf
from yuki_tpu_torch.ops import strat_draws as tsd
from yuki_tpu_torch.sampling import SampleCtx, StratifiedSampler

pytestmark = pytest.mark.cuda

SEED = 2 ** 31 + 4567
STRATA = [(4, 4), (1, 1), (3, 3), (5, 2)]


def _lanes(n, device):
    rng = np.random.default_rng(n)
    px = torch.as_tensor(rng.integers(0, 1920, n), dtype=torch.int32)
    py = torch.as_tensor(rng.integers(0, 1080, n), dtype=torch.int32)
    return px.to(device), py.to(device)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("n", [0, 1000, 65_537], ids=lambda n: f"n{n}")
@pytest.mark.parametrize("jitter", [True, False], ids=["jitter", "centre"])
@pytest.mark.parametrize("strata", STRATA, ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_planes_equal_cpu_route(cuda, strata, jitter, n):
    """One launch gives the CPU route's planes for a wave's draw list (two
    lights, depth 3) and for get_1d / get_2d."""
    sam = StratifiedSampler(*strata, jitter=jitter)
    px, py = _lanes(n, cuda)
    draws = [(0, 2)]
    for b in range(3):
        draws += tpf._bounce_draw_list(2 + b * 7, 2)
    for si in sorted({0, sam.samples_per_pixel - 1}):
        ctx = SampleCtx(px=px, py=py, sample_index=si, seed=SEED)
        ctx_cpu = SampleCtx(px=px.cpu(), py=py.cpu(), sample_index=si,
                            seed=SEED)
        want = tsd.strat_draws_plain(sam, ctx_cpu, draws)
        want_1d, want_2d = sam.get_1d(ctx_cpu, 9), sam.get_2d(ctx_cpu, 4)
        profiling.reset_counts()
        tsd.reset_launches()
        got = tsd.strat_draws(sam, ctx, draws)
        one = sam.get_1d(ctx, 9)
        two = sam.get_2d(ctx, 4)
        torch.cuda.synchronize()
        planes = sum(k for _, k in draws)
        assert got.shape == (planes, n) and two.shape == (n, 2)
        assert np.array_equal(_bits(got), _bits(want))
        c = profiling.counts()
        assert np.array_equal(_bits(one), _bits(want_1d))
        assert np.array_equal(_bits(two), _bits(want_2d))
        assert c["sampling.draws_kernel"] == len(draws) + 2
        assert "sampling.draws_plain" not in c
        assert "host_reads.sampling" not in c
        assert tsd.LAUNCHES["strat_draws"] == (3 if n else 0)
    profiling.reset_counts()


def test_long_draw_list_takes_more_launches(cuda):
    """Past MAX_DRAWS draws the entry point launches again for the rest,
    the planes still in list order."""
    sam = StratifiedSampler(3, 3)
    px, py = _lanes(777, cuda)
    draws = [(d, 1 + d % 2) for d in range(tsd.MAX_DRAWS + 40)]
    ctx = SampleCtx(px=px, py=py, sample_index=4, seed=SEED)
    ctx_cpu = SampleCtx(px=px.cpu(), py=py.cpu(), sample_index=4, seed=SEED)
    tsd.reset_launches()
    got = tsd.strat_draws(sam, ctx, draws)
    assert tsd.LAUNCHES["strat_draws"] == 2
    want = tsd.strat_draws_plain(sam, ctx_cpu, draws)
    assert np.array_equal(_bits(got), _bits(want))


def test_card_lanes_refuse_tensor_keys(cuda):
    """Card lanes always launch the kernel: a numpy integer key is taken
    as its value, a tensor key raises instead of taking the torch route."""
    sam = StratifiedSampler(4, 4)
    px, py = _lanes(300, cuda)
    ctx = SampleCtx(px=px, py=py, sample_index=np.int64(7), seed=SEED)
    ctx_cpu = SampleCtx(px=px.cpu(), py=py.cpu(), sample_index=7, seed=SEED)
    profiling.reset_counts()
    assert np.array_equal(_bits(sam.get_2d(ctx, 3)),
                          _bits(sam.get_2d(ctx_cpu, 3)))
    c = profiling.counts()
    assert c["sampling.draws_kernel"] == 1
    assert c["sampling.draws_plain"] == 1  # the CPU reference
    for bad in (ctx._replace(sample_index=torch.full_like(px, 7)),
                ctx._replace(seed=torch.tensor(SEED, device=cuda))):
        with pytest.raises(TypeError):
            sam.get_1d(bad, 0)
    profiling.reset_counts()


def test_path_li_wave_strat_equals_torch_draws(cuda, monkeypatch):
    """The dense wave with StratifiedSampler(4, 4) on the card gives the
    bits of the same call built with the torch draws, with no host read
    and no plain draw of its own."""
    tb, px, py = _setup("cornell", cuda)
    sam = StratifiedSampler(4, 4)
    out = {}
    for route in ("kernel", "torch"):
        if route == "torch":
            monkeypatch.setattr(tpf, "strat_draws", tsd.strat_draws_plain)
        profiling.reset_counts()
        tsd.reset_launches()
        out[route] = [tpf.path_li_wave(tb, px, py, si, SEED, sam)
                      for si in (0, 15)]
        torch.cuda.synchronize()
        c = profiling.counts()
        if route == "kernel":
            assert tsd.LAUNCHES["strat_draws"] == 2
            assert c["sampling.draws_kernel"] == 2 * (1 + DEPTH * 3)
            assert "sampling.draws_plain" not in c
            assert "host_reads.sampling" not in c
        else:
            assert c["sampling.draws_plain"] == 2 * (1 + DEPTH * 3)
    for (li_k, rc_k), (li_t, rc_t) in zip(out["kernel"], out["torch"]):
        assert np.array_equal(_bits(li_k), _bits(li_t))
        assert torch.equal(rc_k, rc_t)
        assert int(rc_k.sum()) > px.shape[0]
    profiling.reset_counts()
