"""Stateless counter-based sampler; port of ``yuki_tpu/sampling.py``.

A sample value depends only on ``(seed, pixel, sample_index, dimension)``
(the pbrt-v4 seeking contract, yuki/src/sampling/mod.rs:46-57), so any
lane can compute any dimension and no ``torch.Generator`` is needed.

torch has no general uint32 arithmetic, so a u32 here is an ``int64``
tensor holding a value in [0, 2^32): every product of two u32 operands
used below stays under 2^63, and each result is masked back to 32 bits,
which makes the hash bit-identical to ``yuki_tpu``'s ``jnp.uint32`` form.

``StratifiedSampler`` is not ported yet (ROADMAP Queue 1 item 2); the
fused wave's gate rejects it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Union

import torch

from .vecmath import sqrt as _sqrt

MASK32 = 0xFFFFFFFF
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
    d = torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1) * r[..., None]
    return torch.where(degenerate[..., None], torch.zeros_like(d), d)


def cosine_sample_hemisphere(u: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere about +z; u is [...,2] -> [...,3]."""
    d = concentric_sample_disk(u)
    z = _sqrt(torch.clamp(1.0 - d[..., 0] * d[..., 0]
                               - d[..., 1] * d[..., 1], min=0.0))
    return torch.stack([d[..., 0], d[..., 1], z], dim=-1)
