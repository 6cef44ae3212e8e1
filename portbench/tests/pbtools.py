"""Tiny versions of the benchmark's cells for the CPU tests: the same
configuration, traffic and limits files, at a resolution, wave size,
sample count and pixel sample a test run can hold."""

from __future__ import annotations

import dataclasses

from portbench import harness

SMALL_ATRIUM = dict(columns_x=3, columns_z=2, segments=8, rings=2,
                    drape_res=[6, 8])


# Cells with files in portbench/ that BENCHMARK.json does not run (yet).
HELD = {"atrium.path-uniform1": ("atrium", "path-uniform1")}


def tiny_cell(name: str, res=(64, 48), wave_tiles: int = 4,
              check_pixels: int = 64):
    """The cell ``name`` cut to a CPU test's size: spp 16 becomes 4 (2 x 2
    strata), the atrium its 1,024-triangle variant."""
    cell = (harness.make_cell(name, *HELD[name]) if name in HELD
            else harness.load_cell(name))
    cfg = dict(cell.cfg, res=list(res), wave_tiles=wave_tiles)
    if cell.config_name == "atrium":
        cfg["generator"] = dict(SMALL_ATRIUM)
    tr = dict(cell.traffic, check_pixels=check_pixels)
    if tr["pixel_samples"] == [16]:
        tr.update(pixel_samples=[4], samples_per_launch=4)
    if tr["pixel_samples"] == [4, 4]:
        tr.update(pixel_samples=[2, 2], samples_per_launch=4)
    return dataclasses.replace(cell, cfg=cfg, traffic=tr)
