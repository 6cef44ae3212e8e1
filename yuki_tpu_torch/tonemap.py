"""Tone mapping on tensors: port of ``yuki_tpu/tonemap.py`` (:39-105).

The reference runs these as GLSL fullscreen passes (app/renderpasses/
tonemap.rs); here they are elementwise tensor ops over the film plane, on
the image's device:
  * Filmic: exposure + the Stephen Hill ACES fit (MJP/Neubelt port,
    tonemap.rs:318-385).
  * Heatmap: channel-or-luminance -> blue/green/red gradient with min/max
    bounds (tonemap.rs:387-422).

Each 3x3 colour matrix row is summed left to right, and every divide is
by a tensor (on CUDA a divide by a Python scalar becomes a reciprocal
multiply).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

ACES_INPUT = np.array(
    [
        [0.59719, 0.35458, 0.04823],
        [0.07600, 0.90834, 0.01566],
        [0.02840, 0.13383, 0.83777],
    ],
    dtype=np.float32,
)

ACES_OUTPUT = np.array(
    [
        [1.60475, -0.53108, -0.07367],
        [-0.10208, 1.10813, -0.00605],
        [-0.00327, -0.07276, 1.07602],
    ],
    dtype=np.float32,
)


@dataclass(frozen=True)
class FilmicParams:
    exposure: float = 1.0


@dataclass(frozen=True)
class HeatmapParams:
    channel: Optional[int] = None  # None = luminance, else 0/1/2
    min_val: float = 0.0
    max_val: float = 1.0


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _mat3(m: np.ndarray, c: torch.Tensor) -> torch.Tensor:
    """m [3,3] applied to c [...,3]."""
    return torch.stack(
        [float(m[i, 0]) * c[..., 0] + float(m[i, 1]) * c[..., 1]
         + float(m[i, 2]) * c[..., 2] for i in range(3)],
        dim=-1,
    )


def _rrt_odt_fit(v: torch.Tensor) -> torch.Tensor:
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return a / b


def aces_fitted(color: torch.Tensor) -> torch.Tensor:
    """color [...,3] linear -> tonemapped [0,1]."""
    c = _mat3(ACES_INPUT, color)
    c = _rrt_odt_fit(c)
    c = _mat3(ACES_OUTPUT, c)
    return torch.clamp(c, 0.0, 1.0)


def filmic(color: torch.Tensor,
           params: FilmicParams = FilmicParams()) -> torch.Tensor:
    """Exposure + ACES. Caller handles sample-count normalization."""
    return aces_fitted(color * params.exposure)


def _value(color, channel):
    if channel is not None and 0 < channel < 3:
        return color[..., channel]
    return (0.2126 * color[..., 0] + 0.7152 * color[..., 1]
            + 0.0722 * color[..., 2])


def heatmap(color: torch.Tensor, params: HeatmapParams) -> torch.Tensor:
    value = _value(color, params.channel)
    scaled = (value - params.min_val) / _f32(
        params.max_val - params.min_val, value)
    low = torch.tensor([0.0, 0.0, 1.0], device=color.device)
    mid = torch.tensor([0.0, 1.0, 0.0], device=color.device)
    high = torch.tensor([1.0, 0.0, 0.0], device=color.device)
    t1 = torch.clamp(scaled * 2.0, 0.0, 1.0)[..., None]
    t2 = torch.clamp(scaled * 2.0 - 1.0, 0.0, 1.0)[..., None]
    return (low + (mid - low) * t1) * (1.0 - t2) + high * t2


def find_min_max(color, channel: Optional[int]) -> tuple[float, float]:
    """Scan used to auto-range the heatmap (tonemap.rs:447-472); color is
    a tensor or a numpy array."""
    v = _value(color, channel)
    return float(v.min()), float(v.max())


def srgb_encode(c: torch.Tensor) -> torch.Tensor:
    """Shader-side sRGB gamma (renderpasses/scale_output.rs:60-117)."""
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(
        c <= 0.0031308, 12.92 * c,
        1.055 * torch.pow(c, _f32(1.0 / 2.4, c)) - 0.055,
    )
