"""The atrium asset in the port: yuki_tpu_torch.scene.atrium writes the
same bytes as tools/make_atrium_assets.py (small and full), and the
port's renders hold against yuki_tpu's XLA path_li render of yuki_tpu's
load_pbrt of the same files (torch_parity.atrium_golden_jax): the small
atrium (1,024 triangles, the fused wave's plain versions on the CPU)
against tests/goldens/torch_atrium_small_64x48_path3_1spp_seed1.npz,
the full one (347,136 triangles, the treelet dispatch and the fused
shade and resolve, with the point light and the infinite background)
against tests/goldens/torch_atrium_64x48_path3_1spp_seed1.npz.
chip_smoke.py holds the card's renders to the same files."""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity as tp
from yuki_tpu_torch.film import FilmSettings
from yuki_tpu_torch.integrators import PathParams
from yuki_tpu_torch.renderer import render_frame
from yuki_tpu_torch.sampling import UniformSampler
from yuki_tpu_torch.scene import atrium

torch.set_num_threads(2)

GOLDEN = (Path(__file__).parent / "goldens"
          / "torch_atrium_small_64x48_path3_1spp_seed1.npz")
FULL_GOLDEN = (Path(__file__).parent / "goldens"
               / "torch_atrium_64x48_path3_1spp_seed1.npz")


def tool_write_scene():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from make_atrium_assets import write_scene

    return write_scene


def tree_bytes(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("small", [True, False], ids=["small", "full"])
def test_files_byte_identical(tmp_path, small):
    ref = tool_write_scene()(str(tmp_path / "tool"), small=small)
    got = atrium.write_scene(str(tmp_path / "port"), small=small)
    assert got == ref
    assert ref["total"] == (1024 if small else 347136)
    a, b = tree_bytes(tmp_path / "tool"), tree_bytes(tmp_path / "port")
    assert sorted(a) == sorted(b) == [
        "atrium.pbrt", "plys/drape_green.ply", "plys/drape_red.ply",
        "plys/floor.ply", "plys/stone.ply"]
    for name in a:
        assert a[name] == b[name], name


def test_load_atrium_generates_on_first_use(tmp_path):
    scene, cam, fs = atrium.load_atrium(device="cpu", small=True,
                                        out_dir=str(tmp_path))
    assert (tmp_path / "atrium.pbrt").exists()
    assert scene.meta.n_tris == 1024 and scene.meta.n_spheres == 2
    assert scene.meta.traversal == "dense" and fs.res == (1920, 1080)
    again, _, _ = atrium.load_atrium(device="cpu", small=True,
                                     out_dir=str(tmp_path))
    assert torch.equal(again.data.tris.shading_packed,
                       scene.data.tris.shading_packed)


def test_golden_is_current(tmp_path):
    np.testing.assert_array_equal(tp.atrium_golden_jax(tmp_path, small=True),
                                  np.load(GOLDEN)["img"])


def port_render(out_dir, small):
    scene, cam, _ = atrium.load_atrium(device="cpu", small=small,
                                       out_dir=str(out_dir))
    assert scene.meta.traversal == ("dense" if small else "treelet")
    res = render_frame(scene, cam, FilmSettings(res=tp.RES, tile_dim=16),
                       UniformSampler(1), PathParams(3), wave_tiles=12,
                       seed=1)
    return res.film.image()


def test_port_matches_golden(tmp_path):
    img = port_render(tmp_path, small=True)
    gold = np.load(GOLDEN)["img"]
    assert img.shape == gold.shape and np.isfinite(img).all()
    tp.assert_parity(gold, None, img, None, depth=3)


def test_full_golden_is_current(tmp_path):
    np.testing.assert_array_equal(
        tp.atrium_golden_jax(tmp_path, small=False),
        np.load(FULL_GOLDEN)["img"])


def test_port_matches_full_golden(tmp_path):
    img = port_render(tmp_path, small=False)
    gold = np.load(FULL_GOLDEN)["img"]
    assert img.shape == gold.shape and np.isfinite(img).all()
    tp.assert_parity(gold, None, img, None, depth=3)
