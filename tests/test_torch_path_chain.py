"""path_li's shading chain (surface, bsdf, lights, _nee) on the CPU, the
route it takes where the fused shade gate fails: with
FUSED_SHADE_MODE "off" against the committed Cornell golden
(tests/goldens/cornell_64x48_path4_8spp_seed42.npz, yuki_tpu's chain)
and against the port's fused route on the same film; on a lightless scene
and on a textured sphere (sun-sphere), which the gate refuses, against
yuki_tpu's make_wave_renderer, whose path_li takes its chain there too.
Renders are held under torch_parity.assert_parity's bounds."""

from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity as tp
from yuki_tpu_torch import integrators as tintg
from yuki_tpu_torch.film import FilmSettings
from yuki_tpu_torch.integrators import PathParams
from yuki_tpu_torch.ops import path_fused as tpf
from yuki_tpu_torch.ops import shade_fused as tsf
from yuki_tpu_torch.renderer import render_frame
from yuki_tpu_torch.sampling import StratifiedSampler, UniformSampler

torch.set_num_threads(2)

GOLDEN = Path(__file__).parent / "goldens" / "cornell_64x48_path4_8spp_seed42.npz"


@pytest.fixture
def no_wave(monkeypatch):
    monkeypatch.setattr(tpf, "PATH_FUSED_MODE", "off")


def _cornell(spp, depth, seed=42):
    scene, cam = tp.port_scene("cornell")
    res = render_frame(scene, cam, FilmSettings(res=tp.RES, tile_dim=16),
                       UniformSampler(spp), PathParams(depth), wave_tiles=12,
                       seed=seed)
    return res.film.image(), res.ray_count


def test_chain_holds_cornell_golden(no_wave, monkeypatch):
    monkeypatch.setattr(tintg, "FUSED_SHADE_MODE", "off")
    tsf.reset_launches()
    img, _ = _cornell(8, 4)
    assert tsf.LAUNCHES == {"shade": 0, "resolve": 0}
    gold = np.load(GOLDEN)["img"]
    assert np.isfinite(img).all()
    tp.assert_parity(gold, None, img, None, depth=4, spp=8)


@pytest.mark.parametrize("depth", [2, 4])
def test_chain_matches_fused_route(no_wave, monkeypatch, depth):
    """The chain and the shade kernels' plain versions on the same film:
    at depth 2 to rtol 2e-5 (they round a few divides differently: the
    kernel multiplies by reciprocals as yuki_tpu's kernel does), deeper
    under the chaos-aware bounds; ray counts within them."""
    fused, rays_f = _cornell(2, depth, seed=3)
    monkeypatch.setattr(tintg, "FUSED_SHADE_MODE", "off")
    chain, rays_c = _cornell(2, depth, seed=3)
    tp.assert_parity(fused, rays_f if depth > 2 else None, chain,
                     rays_c if depth > 2 else None, depth=depth, spp=2,
                     rtol_shallow=2e-5)
    if depth <= 2:
        assert abs(rays_f - rays_c) <= 2


@pytest.mark.parametrize("name,depth", [("lightless", 3),
                                        ("sun-sphere", 2)])
def test_chain_matches_jax_where_the_gate_fails(name, depth):
    tscene, _ = tp.port_scene(name)
    assert not tintg.use_fused_shade(tscene.meta, UniformSampler(1))
    ref, rays_ref, got, rays_got = tp.render_path_li_both(name, depth)
    assert np.isfinite(got).all() and got.mean() > 0
    tp.assert_parity(ref, rays_ref, got, rays_got, depth, rtol_shallow=2e-5)


def test_gate():
    cornell, _ = tp.port_scene("cornell")
    lightless, _ = tp.port_scene("lightless")
    sun, _ = tp.port_scene("sun-sphere")
    assert lightless.meta.light_types == ()
    assert not sun.meta.sphere_mats_untextured
    for sam in (UniformSampler(1), StratifiedSampler(2, 2)):
        assert tintg.use_fused_shade(cornell.meta, sam)
        assert not tintg.use_fused_shade(lightless.meta, sam)
        assert not tintg.use_fused_shade(sun.meta, sam)
    old = tintg.FUSED_SHADE_MODE
    try:
        tintg.FUSED_SHADE_MODE = "off"
        assert not tintg.use_fused_shade(cornell.meta, UniformSampler(1))
        tintg.FUSED_SHADE_MODE = "interpret"
        with pytest.raises(ValueError, match="FUSED_SHADE_MODE"):
            tintg.use_fused_shade(cornell.meta, UniformSampler(1))
    finally:
        tintg.FUSED_SHADE_MODE = old
