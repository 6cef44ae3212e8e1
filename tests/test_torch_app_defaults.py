"""The app's defaults on the port, on the CPU: make_wave_renderer builds
every integrator yuki_tpu renders (Path on the fused wave and through
path_li, Whitted, the four debug views) and refuses an unknown one; the
Heatmap tone map over BVHIntersections; and ``python -m yuki_tpu_torch
--out=x.exr`` with no settings file (InitialSettings: Cornell, Whitted(3),
StratifiedSampler(1, 1), 640x480, Filmic; the defaults fix that
resolution) exits 0 with an EXR equal bit for bit to the in-process
render of the same settings."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity as tp
from yuki_tpu_torch.camera import Camera
from yuki_tpu_torch.film import FilmSettings
from yuki_tpu_torch.integrators import PathParams, WhittedParams
from yuki_tpu_torch.ops import path_fused as tpf
from yuki_tpu_torch.renderer import make_wave_renderer, render_frame
from yuki_tpu_torch.sampling import StratifiedSampler, UniformSampler

torch.set_num_threads(2)

REPO = Path(__file__).parent.parent


@pytest.mark.parametrize("integrator", [
    PathParams(2), WhittedParams(3), "geometry_normals", "shading_normals",
    "shading_uvs", "bvh_intersections"], ids=str)
@pytest.mark.parametrize("wave", ["auto", "off"])
def test_every_integrator_renders(integrator, wave, monkeypatch):
    monkeypatch.setattr(tpf, "PATH_FUSED_MODE", wave)
    scene, cam = tp.port_scene("cornell")
    render = make_wave_renderer(scene, Camera.create(cam, *tp.RES),
                                StratifiedSampler(2, 1), integrator, tp.TD,
                                2)
    px, rays = render(tp.ORIGINS[:2], 0, 1)
    assert px.shape == (2, tp.TD, tp.TD, 3) and torch.isfinite(px).all()
    assert float(px.max()) > 0 and float(rays) >= 2 * tp.TD * tp.TD


def test_unknown_integrator_raises():
    scene, cam = tp.port_scene("cornell")
    with pytest.raises(ValueError, match="unknown integrator 'ao'"):
        make_wave_renderer(scene, Camera.create(cam, *tp.RES),
                           UniformSampler(1), "ao", tp.TD, 2)


def test_heatmap_over_bvh_intersections():
    """yuki_tpu's Heatmap over its BVHIntersections film: the steps
    normalized between their min and max, through the colour ramp."""
    from yuki_tpu.tonemap import HeatmapParams as JHeat
    from yuki_tpu.tonemap import find_min_max as jfind_min_max
    from yuki_tpu.tonemap import heatmap as jheatmap
    from yuki_tpu_torch.tonemap import HeatmapParams, find_min_max, heatmap

    scene, cam = tp.port_scene("cornell")
    res = render_frame(scene, cam, FilmSettings(res=tp.RES, tile_dim=16),
                       UniformSampler(1), "bvh_intersections",
                       wave_tiles=12, seed=1)
    img = res.film.image_device()
    lo, hi = find_min_max(img, 0)
    assert (lo, hi) == jfind_min_max(img.numpy(), 0) and hi > lo
    got = heatmap(img, HeatmapParams(0, lo, hi)).numpy()
    ref = np.asarray(jheatmap(img.numpy(), JHeat(0, lo, hi)))
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (tp.RES[1], tp.RES[0], 3) and got.max() > 0.5


def test_cli_default_settings(tmp_path):
    from yuki_tpu_torch.app.exr import read_exr
    from yuki_tpu_torch.app.settings import InitialSettings
    from yuki_tpu_torch.app.util import try_load_scene
    from yuki_tpu_torch.tonemap import FilmicParams, filmic

    proc = subprocess.run(
        [sys.executable, "-m", "yuki_tpu_torch", "--device", "cpu",
         "--out=x.exr"], cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = read_exr(str(tmp_path / "x.exr"))

    s = InitialSettings()
    assert isinstance(s.integrator, WhittedParams)
    assert isinstance(s.sampler, StratifiedSampler)
    assert s.film_settings.res == (640, 480) and s.tone_map.kind == "Filmic"
    scene, cam, _, _ = try_load_scene(s.load_settings, device="cpu")
    res = render_frame(scene, cam, s.film_settings, s.sampler, s.integrator,
                       wave_tiles=s.render_settings.wave_tiles, seed=0)
    ref = filmic(res.film.image_device(), FilmicParams()).numpy()
    assert got.shape == ref.shape == (480, 640, 3)
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert ref.mean() > 0.05
