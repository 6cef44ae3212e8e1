"""The colonnade golden, the port's JAX-free tie to the reference on the
treelet path: tests/goldens/torch_colonnade_64x48_path3_1spp_seed1.npz
holds yuki_tpu's XLA path_li render of the full colonnade (124,478
triangles) at 64x48, depth 3, 1 spp, seed 1 (torch_parity.
colonnade_golden_jax).  One test shows the file is current; the other
holds the port's CPU render to it under the deep bounds of
_assert_parity.  chip_smoke.py holds the card's render to the same file.
"""

from pathlib import Path

import numpy as np
import torch

import torch_parity as tp
from yuki_tpu_torch.film import FilmSettings
from yuki_tpu_torch.integrators import PathParams
from yuki_tpu_torch.renderer import render_frame
from yuki_tpu_torch.sampling import UniformSampler

torch.set_num_threads(2)

GOLDEN = (Path(__file__).parent / "goldens"
          / "torch_colonnade_64x48_path3_1spp_seed1.npz")


def test_golden_is_current():
    np.testing.assert_array_equal(tp.colonnade_golden_jax(),
                                  np.load(GOLDEN)["img"])


def test_port_matches_golden():
    scene, cam = tp.port_scene("colonnade")
    res = render_frame(scene, cam, FilmSettings(res=tp.RES, tile_dim=16),
                       UniformSampler(1), PathParams(3), wave_tiles=12,
                       seed=1)
    img = res.film.image()
    gold = np.load(GOLDEN)["img"]
    assert img.shape == gold.shape and np.isfinite(img).all()
    tp.assert_parity(gold, None, img, None, depth=3)
