"""render_frame's ray count against yuki_tpu's sum of it
(yuki_tpu/renderer/__init__.py:424-431): a wave's launches added in
float32, int() of that sum once a wave, the frame's total a Python int.

The wave renderer is replaced by a stub that returns chosen per-launch
counts, so the test runs in well under a second and imports no JAX.  The
1080p film at 16-pixel tiles in 4096-tile waves is Cornell's main path
(two waves, the second 4064 tiles and 32 of padding); at 16 spp with
samples_per_launch=1 each wave makes 16 launches of about 2^20 rays, so
its running sum passes 2^24 and rounds in float32.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from yuki_tpu_torch import renderer
from yuki_tpu_torch.camera import CameraParameters, FoV
from yuki_tpu_torch.film import FilmSettings

SPP = 16
WAVE_TILES = 4096


def launch_counts(seed, n_waves, launches):
    """[n_waves, launches] rays per launch: 2^20 + 3 plus a small odd or
    even offset, so the float32 running sum past 2^24 rounds."""
    rng = np.random.default_rng(seed)
    return (2 ** 20 + 3 + rng.integers(0, 64, (n_waves, launches))).astype(
        np.int64)


def reference_count(counts):
    """yuki_tpu's loop: per wave rays_acc = rays_acc + rays in float32,
    total_rays += int(float(rays_acc))."""
    total = 0
    for wave in counts:
        acc = None
        for c in wave:
            r = np.float32(c)
            acc = r if acc is None else np.float32(acc + r)
        total += int(float(acc))
    return total


def render(monkeypatch, counts, spl):
    calls = []

    def stub(scene, camera, sampler, integrator, td, wave_tiles,
             samples_per_launch=1):
        assert samples_per_launch == spl

        def call(origins, sample_index, seed):
            wave, launch = divmod(len(calls), counts.shape[1])
            calls.append((int(origins.shape[0]), sample_index))
            px = torch.zeros((origins.shape[0], td, td, 3))
            return px, torch.tensor(float(counts[wave, launch]),
                                    dtype=torch.float32)
        return call

    monkeypatch.setattr(renderer, "make_wave_renderer", stub)
    cam = CameraParameters(position=(0.0, 0.0, -5.0), fov=FoV.x(40.0))
    fs = FilmSettings(res=(1920, 1080), tile_dim=16)
    res = renderer.render_frame(
        SimpleNamespace(device=torch.device("cpu")), cam, fs,
        SimpleNamespace(samples_per_pixel=SPP), None,
        wave_tiles=WAVE_TILES, samples_per_launch=spl, seed=1)
    assert len(calls) == counts.size
    return res.ray_count


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ray_count_sums_as_the_reference(monkeypatch, seed):
    """16 launches a wave, two waves: render_frame's count equals the
    float32 emulation of yuki_tpu's sum, which here differs from the
    exact (float64) sum of the launches."""
    counts = launch_counts(seed, 2, SPP)
    assert all(w.sum() > 2 ** 24 for w in counts)
    got = render(monkeypatch, counts, 1)
    ref = reference_count(counts)
    assert isinstance(got, int)
    assert got == ref
    exact = int(counts.astype(np.float64).sum())
    assert exact != ref, "the case does not round past 2^24"


def test_ray_count_one_launch_a_wave(monkeypatch):
    """samples_per_launch = spp: one launch a wave, whose f32 count is
    taken as it is, each wave's int() added."""
    counts = np.array([[17_000_001], [16_777_217]], np.int64)
    got = render(monkeypatch, counts, SPP)
    assert got == int(np.float32(17_000_001)) + int(np.float32(16_777_217))
    assert got == reference_count(counts)
