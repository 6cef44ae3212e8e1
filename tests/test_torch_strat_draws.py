"""The stratified sampler's draws kernel (``ops/strat_draws``,
``ops/csrc/sampling.cu``) on the CPU: a per-lane scalar model of the
kernel's algorithm (Python ints wrapped to u32, Kensler's rejection as a
per-lane loop, numpy float32 for the IEEE adds and divides) held bit for
bit against ``StratifiedSampler.get_1d`` / ``get_2d``, whose torch code is
the kernel's plain twin; and the draw lists and layouts of
``strat_draws``' plain route.  The kernel itself is held against the
torch route on the card in test_torch_cuda_strat_draws.py."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from yuki_tpu_torch import profiling
from yuki_tpu_torch.ops import path_fused as tpf
from yuki_tpu_torch.ops import strat_draws as tsd
from yuki_tpu_torch.sampling import SampleCtx, StratifiedSampler

M = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
SEED = 2 ** 31 + 12345  # beyond 32 signed bits, as the benchmark's seeds
STRATA = [(4, 4), (1, 1), (3, 3), (5, 2)]


# ---- the kernel's algorithm, one lane at a time --------------------------


def pcg(x: int) -> int:
    state = (x * 747796405 + 2891336453) & M
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & M
    return (word >> 22) ^ word


def perm_round(i: int, p: int, w: int, mult: int) -> int:
    i ^= p
    i = (i * 0xE170893D) & M
    i ^= p >> 16
    i ^= (i & w) >> 4
    i ^= p >> 8
    i = (i * 0x0929EB3F) & M
    i ^= p >> 23
    i ^= (i & w) >> 1
    i = (i * mult) & M
    i = (i * 0x6935FA69) & M
    i ^= (i & w) >> 11
    i = (i * 0x74DCB303) & M
    i ^= (i & w) >> 2
    i = (i * 0x9E501CC3) & M
    i ^= (i & w) >> 2
    i = (i * 0xC860A3DF) & M
    i &= w
    return i ^ (i >> 5)


def permutation_element(i: int, l: int, p: int):
    """(element, rounds run): rounds until the value lands in [0, l), at
    most w + 2 (rounds = w + 3: the lane's cycle holds no such value)."""
    w = l - 1
    for s in (1, 2, 4, 8, 16):
        w |= w >> s
    mult = 1 | (p >> 27)
    rounds = 0
    while rounds < w + 2:
        i = perm_round(i, p, w, mult)
        rounds += 1
        if i < l:
            break
    else:
        rounds += 1
    return ((i + p) & M) % l, rounds


def lane_draw(sampler, px: int, py: int, si: int, seed: int, dim: int,
              two: bool):
    """One lane's draw as the kernel computes it: (f32 values, rounds)."""
    psx, psy = sampler.pixel_samples_x, sampler.pixel_samples_y
    spp = psx * psy
    ph = pcg(pcg(GOLDEN ^ (seed & M)) ^ ((((px & M) << 16) & M) | (py & M)))
    jit = pcg(ph ^ (si & M))
    stratum, rounds = permutation_element(si & M, spp,
                                          pcg(pcg(GOLDEN ^ ph) ^ dim))

    def delta(d):
        if not sampler.jitter:
            return np.float32(0.5)
        return np.float32(pcg(jit ^ d) >> 8) * np.float32(2.0 ** -24)

    if not two:
        return [(np.float32(stratum) + delta(dim)) / np.float32(spp)], rounds
    x = np.float32(stratum % psx) + delta(dim)
    y = np.float32(stratum // psy) + delta(dim + 1)
    return [x / np.float32(psx), y / np.float32(psy)], rounds


def model(sampler, px, py, si: int, seed: int, dim: int, two: bool):
    """The model over lanes: (f32 [N] or [N, 2], rounds per lane)."""
    vals, rounds = zip(*(lane_draw(sampler, int(x), int(y), si, seed, dim,
                                   two) for x, y in zip(px, py)))
    out = np.array(vals, dtype=np.float32)
    return (out if two else out[:, 0]), np.array(rounds)


def _lanes(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    px = torch.as_tensor(rng.integers(0, 1920, n), dtype=torch.int32)
    py = torch.as_tensor(rng.integers(0, 1080, n), dtype=torch.int32)
    return px, py


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("two", [False, True], ids=["1d", "2d"])
@pytest.mark.parametrize("jitter", [True, False], ids=["jitter", "centre"])
@pytest.mark.parametrize("strata", STRATA, ids=lambda s: f"{s[0]}x{s[1]}")
def test_scalar_model_matches_sampler(strata, jitter, two):
    """The kernel's per-lane algorithm gives the torch sampler's bits, for
    sample indices inside and far beyond the stratum count; strata
    counts that are not powers of two reject and re-run some lanes."""
    sam = StratifiedSampler(*strata, jitter=jitter)
    px, py = _lanes(48)
    max_rounds = 0
    for si in (0, sam.samples_per_pixel - 1, 7, 3_000_000_000):
        ctx = SampleCtx(px=px, py=py, sample_index=si, seed=SEED)
        for dim in (0, 3, 7, 22):
            got = (sam.get_2d if two else sam.get_1d)(ctx, dim)
            want, rounds = model(sam, px, py, si, SEED, dim, two)
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
            max_rounds = max(max_rounds, int(rounds.max()))
    spp = sam.samples_per_pixel
    if spp & (spp - 1):
        assert max_rounds >= 2
    else:  # round_fn ends in i & (l - 1): the first round accepts
        assert max_rounds == 1


@pytest.mark.parametrize("strata", [(3, 3), (5, 2)], ids=["3x3", "5x2"])
def test_scalar_model_matches_sampler_after_many_rejections(strata):
    """Lanes that Kensler's rejection re-runs once, twice and five times
    or more (past the torch route's first batch of four rounds) agree
    too."""
    sam = StratifiedSampler(*strata)
    si = sam.samples_per_pixel - 1
    px, py = _lanes(2048, seed=1)
    most = 0
    for dim in (0, 3, 11, 22):
        _, rounds = model(sam, px, py, si, SEED, dim, True)
        keep = torch.as_tensor(np.nonzero(rounds >= 2)[0])
        assert 0 < len(keep) < len(px)
        most = max(most, int(rounds.max()))
        ctx = SampleCtx(px=px[keep], py=py[keep], sample_index=si, seed=SEED)
        want, _ = model(sam, px[keep], py[keep], si, SEED, dim, True)
        np.testing.assert_array_equal(_bits(sam.get_2d(ctx, dim).numpy()),
                                      _bits(want))
    assert 6 <= most <= 8  # the cycle walk ends inside the mask's 16


def test_strat_draws_plain_route_and_counts():
    """On the CPU strat_draws is the sampler's torch draws in list order,
    [planes, *shape], counted as plain draws; no launch, no kernel draw.
    get_2d's pair is the last axis of its two planes."""
    sam = StratifiedSampler(3, 3)
    px, py = _lanes(24)
    px, py = px.reshape(4, 6), py.reshape(4, 6)
    ctx = SampleCtx(px=px, py=py, sample_index=4, seed=SEED)
    draws = [(0, 2), (5, 1), (8, 2)]
    want = torch.stack([*sam.plain_2d(ctx, 0).unbind(-1),
                        sam.plain_1d(ctx, 5), *sam.plain_2d(ctx, 8).unbind(-1)])
    profiling.reset_counts()
    tsd.reset_launches()
    got = tsd.strat_draws(sam, ctx, draws)
    two = sam.get_2d(ctx, 8)
    assert got.shape == (5, 4, 6) and two.shape == (4, 6, 2)
    assert torch.equal(got, want)
    assert torch.equal(two, torch.movedim(want[3:], 0, -1))
    c = profiling.counts()
    assert c["sampling.draws_plain"] == 4
    assert "sampling.draws_kernel" not in c
    assert tsd.LAUNCHES == {"strat_draws": 0}
    with pytest.raises(ValueError):
        tsd.strat_draws(sam, ctx, [(0, 3)])
    profiling.reset_counts()


def test_cpu_lanes_take_per_lane_sample_indices():
    """CPU lanes keep the torch route's per-lane tensor sample index: each
    lane's draw is the one its own integer index gives."""
    sam = StratifiedSampler(3, 3)
    px, py = _lanes(12)
    si = torch.arange(12, dtype=torch.int64) % 9
    ctx = SampleCtx(px=px, py=py, sample_index=si, seed=SEED)
    got = tsd.strat_draws(sam, ctx, [(0, 2), (5, 1)])
    for k in range(12):
        one = SampleCtx(px=px[k:k + 1], py=py[k:k + 1],
                        sample_index=int(si[k]), seed=SEED)
        assert torch.equal(got[:, k:k + 1],
                           tsd.strat_draws(sam, one, [(0, 2), (5, 1)]))


def test_bounce_draws_is_one_bounce_of_strat_planes():
    """bounce_draws gives the [2L+3, N] planes that strat_planes holds for
    the same bounce."""
    sam = StratifiedSampler(5, 2)
    px, py = _lanes(30)
    n_lights, depth = 2, 3
    spl = tpf.strat_planes(sam, px, py, 6, SEED, n_lights, depth)
    ctx = SampleCtx(px=px, py=py, sample_index=6, seed=SEED)
    dpb = 2 * n_lights + 3
    for b in range(depth):
        d0 = 2 + b * dpb
        assert torch.equal(tpf.bounce_draws(sam, ctx, d0, n_lights),
                           spl[d0:d0 + dpb])


def _ctx(si=3, seed=SEED, shape=(8,), py_shape=None):
    t = SimpleNamespace(device=torch.device("cuda"), shape=shape)
    p = SimpleNamespace(device=torch.device("cuda"), shape=py_shape or shape)
    return SampleCtx(px=t, py=p, sample_index=si, seed=seed)


@pytest.mark.parametrize("ctx,keys", [
    (_ctx(), (3, SEED)),
    (_ctx(si=np.int64(2 ** 32 + 5), seed=-1), (5, M)),
], ids=["int", "numpy_int"])
def test_kernel_keys(ctx, keys):
    """Card lanes' sample index and seed reach the kernel as u32 words,
    from any integer type."""
    assert tsd.kernel_keys(ctx) == keys


@pytest.mark.parametrize("ctx,error", [
    (_ctx(si=torch.zeros(8, dtype=torch.int64)), TypeError),
    (_ctx(seed=torch.zeros((), dtype=torch.int64)), TypeError),
    (_ctx(si=2.0), TypeError),
    (_ctx(py_shape=(1,)), ValueError),
], ids=["lane_sample_index", "tensor_seed", "float_sample_index",
        "broadcast"])
def test_kernel_keys_refused(ctx, error):
    """Card lanes never give way to the torch route: a tensor key, or px
    and py of two shapes, raise before any launch."""
    with pytest.raises(error):
        tsd.strat_draws(StratifiedSampler(4, 4), ctx, [(0, 2)])
