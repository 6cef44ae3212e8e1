"""Stateless counter-based sampler; port of ``yuki_tpu/sampling.py``.

A sample value depends only on ``(seed, pixel, sample_index, dimension)``
(the pbrt-v4 seeking contract, yuki/src/sampling/mod.rs:46-57), so any
lane can compute any dimension and no ``torch.Generator`` is needed.

torch has no general uint32 arithmetic, so a u32 here is an ``int64``
tensor holding a value in [0, 2^32), and each result is masked back to 32
bits, which makes the maths bit-identical to ``yuki_tpu``'s ``jnp.uint32``
form.  The PCG constants are under 2^30, so their products stay under
2^63; ``permutation_element``'s multipliers are full 32-bit words, whose
products would not, so ``_mul32`` splits them into 16-bit halves.

Samplers: ``UniformSampler`` and ``StratifiedSampler`` (Kensler's
``permutation_element`` picks each (pixel, dimension)'s stratum, the
pbrt-v4 design of yuki/src/sampling/stratified.rs).  A stratified draw on
CUDA lanes is one launch of the draws kernel (``ops/strat_draws``,
``ops/csrc/sampling.cu``: the same u32 maths with native wrapping, the
rejection per lane, no host read), whose sample index and seed are one
integer for all lanes; the dense wave and the fused shade take a list of
draws as planes from one launch (``ops/path_fused.strat_planes``,
``bounce_draws``).  CPU lanes, with integer or per-lane tensor keys, take
``plain_1d`` / ``plain_2d`` below, the kernel's plain twin;
``profiling``'s ``sampling.draws_kernel`` and ``sampling.draws_plain``
count the draws each route serves.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Union

import torch

from .ops._build import bump
from .ops.strat_draws import strat_draws
from .profiling import COUNTS, host_read
from .vecmath import sqrt as _sqrt

MASK32 = 0xFFFFFFFF
# concentric_sample_disk's transcendentals, named once so that a test can
# evaluate them one way on both sides.
_cos, _sin = torch.cos, torch.sin
GOLDEN = 0x9E3779B9


def _u32(x, device=None) -> torch.Tensor:
    """Python int or integer tensor -> int64 tensor of its u32 bits."""
    if isinstance(x, int):
        return torch.tensor(x & MASK32, dtype=torch.int64, device=device)
    return x.to(torch.int64) & MASK32


def pcg_hash(x) -> torch.Tensor:
    """PCG output permutation used as a mixer (u32 -> u32), Jarzynski &
    Olano 2020; the state and word products wrap to 32 bits."""
    x = _u32(x)
    state = (x * 747796405 + 2891336453) & MASK32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def hash_key(*vals) -> torch.Tensor:
    """Chain-mix a key tuple into a u32 (sampling/mod.rs:89-103 role)."""
    dev = next((v.device for v in vals if isinstance(v, torch.Tensor)), None)
    h = _u32(GOLDEN, dev)
    for v in vals:
        h = pcg_hash(h ^ _u32(v, dev))
    return h


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for u32 ``a`` (in int64) and a u32 constant ``b``,
    by 16-bit halves of b so that no product reaches 2^63."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def u32_to_unit_float(u: torch.Tensor) -> torch.Tensor:
    """u32 -> [0,1) float32: 24 high bits / 2^24."""
    return (u >> 8).to(torch.float32) * (1.0 / (1 << 24))


class SampleCtx(NamedTuple):
    """Per-lane sampler key: which (pixel, sample) each lane is on."""

    px: torch.Tensor  # integer [N] pixel x
    py: torch.Tensor  # integer [N] pixel y
    sample_index: Union[int, torch.Tensor]
    seed: Union[int, torch.Tensor]

    def pixel_hash(self) -> torch.Tensor:
        return hash_key(self.seed, ((_u32(self.px) << 16) & MASK32)
                        | _u32(self.py))


def _dim_u32(ctx: SampleCtx, dim: int) -> torch.Tensor:
    """Raw u32 for (seed, pixel, sample_index, dimension)."""
    ph = ctx.pixel_hash()
    return pcg_hash(
        pcg_hash(ph ^ _u32(ctx.sample_index, ph.device)) ^ _u32(dim, ph.device)
    )


@dataclass(frozen=True)
class UniformSampler:
    """Uncorrelated uniform dimensions; spp = pixel_samples
    (yuki/src/sampling/uniform.rs)."""

    pixel_samples: int = 1

    @property
    def samples_per_pixel(self) -> int:
        return self.pixel_samples

    def get_1d(self, ctx: SampleCtx, dim: int) -> torch.Tensor:
        return u32_to_unit_float(_dim_u32(ctx, dim))

    def get_2d(self, ctx: SampleCtx, dim: int) -> torch.Tensor:
        return torch.stack(
            [
                u32_to_unit_float(_dim_u32(ctx, dim)),
                u32_to_unit_float(_dim_u32(ctx, dim + 1)),
            ],
            dim=-1,
        )


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor beside ``like``: dividing by a tensor keeps
    the IEEE divide, where a Python divisor becomes a reciprocal multiply
    on CUDA."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


@dataclass(frozen=True)
class StratifiedSampler:
    """On-the-fly stratified sampling (yuki/src/sampling/stratified.rs):
    2D dimensions are stratified on a (x, y) grid, 1D on x*y strata; the
    stratum of (pixel, dim) is ``permutation_element`` keyed on
    hash(pixel, dim), the jitter the uniform hash of the dimension."""

    pixel_samples_x: int = 1
    pixel_samples_y: int = 1
    symmetric_dimensions: bool = True  # UI behaviour: edit x edits y too
    jitter: bool = True

    @property
    def samples_per_pixel(self) -> int:
        return self.pixel_samples_x * self.pixel_samples_y

    def _stratum(self, ctx: SampleCtx, dim: int) -> torch.Tensor:
        return permutation_element(ctx.sample_index, self.samples_per_pixel,
                                   hash_key(ctx.pixel_hash(), dim))

    def _delta(self, ctx: SampleCtx, dim: int, like) -> torch.Tensor:
        if self.jitter:
            return u32_to_unit_float(_dim_u32(ctx, dim))
        return _f32(0.5, like)

    def get_1d(self, ctx: SampleCtx, dim: int) -> torch.Tensor:
        return strat_draws(self, ctx, ((dim, 1),))[0]

    def get_2d(self, ctx: SampleCtx, dim: int) -> torch.Tensor:
        return strat_draws(self, ctx, ((dim, 2),)).movedim(0, -1)

    def plain_1d(self, ctx: SampleCtx, dim: int) -> torch.Tensor:
        """``get_1d`` in torch ops (the draws kernel's plain twin)."""
        bump(COUNTS, "sampling.draws_plain")
        stratum = self._stratum(ctx, dim)
        x = stratum.to(torch.float32) + self._delta(ctx, dim, stratum)
        return x / _f32(self.samples_per_pixel, x)

    def plain_2d(self, ctx: SampleCtx, dim: int) -> torch.Tensor:
        """``get_2d`` in torch ops (the draws kernel's plain twin)."""
        bump(COUNTS, "sampling.draws_plain")
        stratum = self._stratum(ctx, dim)
        # The reference divides the stratum by pixel_samples_y for its y
        # index (stratified.rs:131-133); yuki_tpu keeps that, so does this.
        x = (stratum % self.pixel_samples_x).to(torch.float32)
        y = (stratum // self.pixel_samples_y).to(torch.float32)
        x = x + self._delta(ctx, dim, x)
        y = y + self._delta(ctx, dim + 1, y)
        return torch.stack([x / _f32(self.pixel_samples_x, x),
                            y / _f32(self.pixel_samples_y, y)], dim=-1)


Sampler = Union[UniformSampler, StratifiedSampler]


def force_single_sample(sampler: Sampler) -> Sampler:
    """Interactive-preview override (SamplerType::instantiate(force_single_
    sample), sampling/mod.rs:21-32)."""
    if isinstance(sampler, UniformSampler):
        return UniformSampler(pixel_samples=1)
    return StratifiedSampler(
        pixel_samples_x=1,
        pixel_samples_y=1,
        symmetric_dimensions=sampler.symmetric_dimensions,
        jitter=sampler.jitter,
    )


def permutation_element(i, l: int, p: torch.Tensor) -> torch.Tensor:
    """Kensler's hashed permutation of ``i`` (an int or integer tensor) in
    [0, l) keyed by the u32 tensor ``p`` (``yuki_tpu`` sampling.py:76-129,
    stratified.rs:147-178).  Rejected lanes re-run the round on their own
    output until every lane lands in [0, l); an extra round never changes
    an accepted lane, so the rounds run in batches of four with one host
    read per batch (counted in ``host_reads.sampling``)."""
    w = l - 1
    for s in (1, 2, 4, 8, 16):
        w |= w >> s
    p = _u32(p)
    i, p = torch.broadcast_tensors(_u32(i, p.device), p)
    mult = 1 | (p >> 27)  # under 2^5: the plain product fits

    def round_fn(i):
        i = i ^ p
        i = _mul32(i, 0xE170893D)
        i = i ^ (p >> 16)
        i = i ^ ((i & w) >> 4)
        i = i ^ (p >> 8)
        i = _mul32(i, 0x0929EB3F)
        i = i ^ (p >> 23)
        i = i ^ ((i & w) >> 1)
        i = (i * mult) & MASK32
        i = _mul32(i, 0x6935FA69)
        i = i ^ ((i & w) >> 11)
        i = _mul32(i, 0x74DCB303)
        i = i ^ ((i & w) >> 2)
        i = _mul32(i, 0x9E501CC3)
        i = i ^ ((i & w) >> 2)
        i = _mul32(i, 0xC860A3DF)
        i = i & w
        return i ^ (i >> 5)

    i = round_fn(i)
    while host_read((i >= l).any(), "sampling"):
        for _ in range(4):
            i = torch.where(i < l, i, round_fn(i))
    return ((i + p) & MASK32) % l


# --- shared sampling transforms (sampling/mod.rs:62-87) -------------------


def concentric_sample_disk(u: torch.Tensor) -> torch.Tensor:
    """Map [0,1)^2 to the unit disk; u is [...,2]."""
    offset = u * 2.0 - 1.0
    ox, oy = offset[..., 0], offset[..., 1]
    degenerate = (ox == 0.0) & (oy == 0.0)
    one = torch.ones_like(ox)
    ox_s = torch.where(ox == 0.0, one, ox)
    oy_s = torch.where(oy == 0.0, one, oy)
    use_x = torch.abs(ox) > torch.abs(oy)
    theta = torch.where(
        use_x,
        (math.pi / 4.0) * (oy / ox_s),
        (math.pi / 2.0) - (math.pi / 4.0) * (ox / oy_s),
    )
    r = torch.where(use_x, ox, oy)
    d = torch.stack([_cos(theta), _sin(theta)], dim=-1) * r[..., None]
    return torch.where(degenerate[..., None], torch.zeros_like(d), d)


def cosine_sample_hemisphere(u: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere about +z; u is [...,2] -> [...,3]."""
    d = concentric_sample_disk(u)
    z = _sqrt(torch.clamp(1.0 - d[..., 0] * d[..., 0]
                               - d[..., 1] * d[..., 1], min=0.0))
    return torch.stack([d[..., 0], d[..., 1], z], dim=-1)
