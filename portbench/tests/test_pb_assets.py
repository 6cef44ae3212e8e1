"""The configurations' frozen copies against the program's own: the
atrium generator's bytes, and the reference's scene tables against the
tables the program builds from the same description."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from portbench.configs import atrium, cornell

from .pbtools import SMALL_ATRIUM


def test_atrium_files_byte_for_byte(tmp_path):
    from yuki_tpu_torch.scene import atrium as prog

    prog.write_scene(str(tmp_path / "prog"), small=True)
    atrium.write_files({"generator": SMALL_ATRIUM}, str(tmp_path / "bench"))
    for rel in ("atrium.pbrt", "plys/stone.ply", "plys/floor.ply",
                "plys/drape_red.ply", "plys/drape_green.ply"):
        a = (tmp_path / "prog" / rel).read_bytes()
        b = (tmp_path / "bench" / rel).read_bytes()
        assert a == b, rel


def test_atrium_full_size_counts():
    arrays, spheres, _ = atrium._generate({})
    assert sum(t.shape[0] for _, t in arrays.values()) == 347136
    assert len(spheres) == 6


def test_atrium_rewrites_nothing_unchanged(tmp_path):
    cfg = {"generator": SMALL_ATRIUM}
    atrium.write_files(cfg, str(tmp_path))
    before = os.stat(tmp_path / "atrium.pbrt").st_mtime_ns
    atrium.write_files(cfg, str(tmp_path))
    assert os.stat(tmp_path / "atrium.pbrt").st_mtime_ns == before


def _sorted_tris(p0, p1, p2):
    t = np.concatenate([p0, p1, p2], axis=1)
    return t[np.lexsort(t.T[::-1])]


@pytest.mark.parametrize("name", ["cornell", "atrium"])
def test_reference_tables_match_the_programs(name, tmp_path):
    """Same triangles, spheres, lights and background (the reference's
    own builder from the description against the program's loader)."""
    cfg = {"res": [64, 48], "tile_dim": 16}
    mod = cornell if name == "cornell" else atrium
    if name == "atrium":
        cfg["generator"] = SMALL_ATRIUM
    scene, cam, _ = mod.program_scene(cfg, torch.device("cpu"), str(tmp_path))
    sc, spec = mod.reference_scene(cfg, torch.device("cpu"), torch.float32,
                                   str(tmp_path))
    d = scene.data.tris
    a = _sorted_tris(d.p0.numpy(), d.p1.numpy(), d.p2.numpy())
    b = _sorted_tris(sc.tri.p0.numpy(), sc.tri.p1.numpy(), sc.tri.p2.numpy())
    assert np.array_equal(a, b)
    assert torch.equal(scene.data.spheres.obj_to_world.float(), sc.sph.o2w)
    assert torch.equal(scene.data.spheres.radius, sc.sph.radius)
    assert torch.equal(scene.data.background, sc.background)
    assert tuple(scene.meta.light_types) == sc.light_types
    for k, L in enumerate(sc.lights):
        assert torch.equal(scene.data.lights.i[k], L["i"])
        assert torch.equal(scene.data.lights.m[k], L["m"])
    assert tuple(np.float32(v) for v in cam.position) == tuple(
        np.float32(v) for v in spec.position)
    assert cam.fov.axis == spec.fov_axis
    assert np.float32(cam.fov.degrees) == np.float32(spec.fov_degrees)
