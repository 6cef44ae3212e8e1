"""Film: tile-major pixel sums + host-side tile bookkeeping.

Port of ``yuki_tpu/film.py``.  Pixels live on the device in tile-major
layout ``[n_tiles, tile_dim, tile_dim, 3]`` so a whole rendered wave
lands with one indexed add; sample counts are an ``[n_tiles]`` vector and
``image()`` reassembles and sample-normalises the [H,W,3] plane.  Tile
generation and the centre-out spiral (film.rs:299-376) are host code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from .device import resolve_device


@dataclass(frozen=True)
class FilmSettings:
    """FilmSettings (film.rs:13-39); defaults match the reference."""

    res: Tuple[int, int] = (640, 480)  # (x, y)
    tile_dim: int = 16
    clear: bool = True
    accumulate: bool = False
    sixteenth_res: bool = False

    def effective_res(self) -> Tuple[int, int]:
        """1/16th-res preview divides each axis by 4 (film.rs:25-26)."""
        if self.sixteenth_res:
            return (max(self.res[0] // 4, 1), max(self.res[1] // 4, 1))
        return self.res


@dataclass(frozen=True)
class FilmTile:
    """Pixel-bounds tile; sample = accumulation generation (film.rs:41-65)."""

    x0: int
    y0: int
    index: int  # flat tile index in the tile-major buffer
    sample: int = 0


def tile_grid(res_x: int, res_y: int, tile_dim: int) -> Tuple[int, int]:
    return (
        (res_x + tile_dim - 1) // tile_dim,
        (res_y + tile_dim - 1) // tile_dim,
    )


def generate_tiles(res_x: int, res_y: int, tile_dim: int) -> dict:
    """Grid partition hashed by tile coords (film.rs:299-331)."""
    tiles = {}
    tx, _ = tile_grid(res_x, res_y, tile_dim)
    for tj, j in enumerate(range(0, res_y, tile_dim)):
        for ti, i in enumerate(range(0, res_x, tile_dim)):
            tiles[(ti, tj)] = FilmTile(i, j, tj * tx + ti)
    return tiles


def outward_spiral(tiles: dict, res_x: int, res_y: int, tile_dim: int) -> List[FilmTile]:
    """Center-out spiral ordering (film.rs:333-376)."""
    h_tiles, v_tiles = tile_grid(res_x, res_y, tile_dim)
    center_x = (h_tiles // 2) - (1 - h_tiles % 2)
    center_y = (v_tiles // 2) - (1 - v_tiles % 2)
    max_dim = max(h_tiles, v_tiles)
    x = y = 0
    dx, dy = 0, -1
    order = []
    for _ in range(max_dim * max_dim):
        tx, ty = center_x + x, center_y + y
        if 0 <= tx < h_tiles and 0 <= ty < v_tiles:
            order.append(tiles.pop((tx, ty)))
        if x == y or (x < 0 and x == -y) or (x > 0 and x == 1 - y):
            dx, dy = -dy, dx
        x += dx
        y += dy
    return order


def film_tiles(settings: FilmSettings) -> List[FilmTile]:
    rx, ry = settings.effective_res()
    td = settings.tile_dim
    return outward_spiral(generate_tiles(rx, ry, td), rx, ry, td)


class Film:
    """Tile-major pixel sums + per-tile sample counts on ``device``."""

    def __init__(self, res_x: int, res_y: int, tile_dim: int, device=None):
        self.device = resolve_device(device)
        self.res = (res_x, res_y)
        self.tile_dim = tile_dim
        self.grid = tile_grid(res_x, res_y, tile_dim)
        n_tiles = self.grid[0] * self.grid[1]
        self.tiles_buf = torch.zeros(
            (n_tiles, tile_dim, tile_dim, 3), dtype=torch.float32,
            device=self.device,
        )
        self.samples = torch.zeros(
            (n_tiles,), dtype=torch.int32, device=self.device
        )

    @property
    def n_tiles(self) -> int:
        return self.tiles_buf.shape[0]

    def add_tiles(self, tile_ids: torch.Tensor, tile_pixels: torch.Tensor):
        """Add a rendered wave: tile_ids [B], pixels [B,td,td,3].  Each
        tile contributes one sample generation.  Out-of-range ids (wave
        padding) are dropped.  Ids within a wave are distinct, so the
        indexed add is deterministic."""
        ids = torch.as_tensor(tile_ids, device=self.device).long()
        keep = (ids >= 0) & (ids < self.n_tiles)
        ids = ids[keep]
        self.tiles_buf.index_add_(0, ids, tile_pixels[keep])
        self.samples.index_add_(
            0, ids, torch.ones_like(ids, dtype=torch.int32)
        )

    def image_tensor(self) -> torch.Tensor:
        """Sample-normalised [H,W,3] image on the film's device."""
        tx, ty = self.grid
        td = self.tile_dim
        counts = torch.clamp(self.samples, min=1).to(torch.float32)
        norm = self.tiles_buf / counts[:, None, None, None]
        img = norm.reshape(ty, tx, td, td, 3).permute(0, 2, 1, 3, 4)
        img = img.reshape(ty * td, tx * td, 3)
        return img[: self.res[1], : self.res[0]]

    def image(self) -> np.ndarray:
        return self.image_tensor().cpu().numpy()
