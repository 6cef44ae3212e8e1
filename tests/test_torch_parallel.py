"""The port's multi-device rendering (yuki_tpu_torch/parallel) on meshes of
CPU devices: tests/test_parallel.py's contract, no JAX.

On the Cornell 64x48 film with 8-pixel tiles (all 48 tiles), every tiles
partition gives tiles bit for bit equal to the single-device renderer's
over the same origins (its path_li route, PATH_FUSED_MODE "off", which is
the route each shard takes; at depth 2 also the fused wave's, as in
yuki_tpu's test), rays equal; the samples axis equals the single-device
generations summed in order.
"""

import numpy as np
import pytest
import torch

from yuki_tpu_torch.camera import Camera
from yuki_tpu_torch.integrators import PathParams, WhittedParams
from yuki_tpu_torch.ops import path_fused
from yuki_tpu_torch.parallel import (default_mesh, make_sharded_wave_renderer,
                                     scene_to)
from yuki_tpu_torch.renderer import make_wave_renderer
from yuki_tpu_torch.sampling import StratifiedSampler, UniformSampler
from yuki_tpu_torch.scene.cornell import cornell

torch.set_num_threads(2)

TD = 8
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def setup():
    scene, cam_params, _ = cornell(device="cpu")
    origins = torch.as_tensor(np.stack(
        [np.arange(48) % 8 * TD, np.arange(48) // 8 * TD], 1),
        dtype=torch.int32)
    return scene, Camera.create(cam_params, 64, 48), origins


def single(setup, sampler, integ, sample_index, seed, mode="off"):
    scene, camera, origins = setup
    saved = path_fused.PATH_FUSED_MODE
    path_fused.PATH_FUSED_MODE = mode
    try:
        fn = make_wave_renderer(scene, camera, sampler, integ, TD, 48)
        return fn(origins, sample_index, seed)
    finally:
        path_fused.PATH_FUSED_MODE = saved


@pytest.mark.parametrize("n_tiles", (1, 2, 8))
def test_tiles_match_single_device(setup, n_tiles):
    """Any tiles partition: tiles and rays bit for bit."""
    scene, camera, origins = setup
    sampler, integ = UniformSampler(1), PathParams(max_depth=3)
    ref, ref_rays = single(setup, sampler, integ, 0, 7)
    mesh = default_mesh(n_tiles, 1, CPU8[:n_tiles])
    px, rays = make_sharded_wave_renderer(scene, camera, sampler, integ, TD,
                                          mesh)(origins, 0, 7)
    assert torch.equal(px, ref)
    assert float(rays) == float(ref_rays) > 0


def test_matches_fused_wave_depth2(setup):
    """Eight tiles shards at depth 2 against the default renderer (the
    fused dense wave on Cornell), bit for bit, as yuki_tpu's test holds
    its shards."""
    scene, camera, origins = setup
    sampler, integ = UniformSampler(1), PathParams(max_depth=2)
    ref, ref_rays = single(setup, sampler, integ, 0, 7, mode="auto")
    px, rays = make_sharded_wave_renderer(
        scene, camera, sampler, integ, TD, default_mesh(8, 1, CPU8))(
        origins, 0, 7)
    assert torch.equal(px, ref) and float(rays) == float(ref_rays)


def test_samples_axis_sums_generations(setup):
    """A 4 x 2 mesh, two samples a launch: each samples shard renders its
    generation; their sum equals the single-device generations' sum."""
    scene, camera, origins = setup
    sampler, integ = UniformSampler(2), PathParams(max_depth=2)
    g0, r0 = single(setup, sampler, integ, 0, 3)
    g1, r1 = single(setup, sampler, integ, 1, 3)
    mesh = default_mesh(4, 2, CPU8)
    assert mesh.shape == {"tiles": 4, "samples": 2}
    px, rays = make_sharded_wave_renderer(scene, camera, sampler, integ, TD,
                                          mesh, samples_per_launch=2)(
        origins, 0, 3)
    assert torch.equal(px, g0 + g1)
    assert float(rays) == float(r0 + r1)


def test_whitted_stratified_shards(setup):
    """Whitted with the stratified sampler, 2 x 2 mesh, four samples a
    launch (two generations a samples shard, added in order)."""
    scene, camera, origins = setup
    sampler, integ = StratifiedSampler(2, 2), WhittedParams(max_depth=2)
    gens = [single(setup, sampler, integ, s, 5)[0] for s in range(4)]
    px, _ = make_sharded_wave_renderer(
        scene, camera, sampler, integ, TD, default_mesh(2, 2, CPU8[:4]),
        samples_per_launch=4)(origins, 0, 5)
    assert torch.equal(px, (gens[0] + gens[1]) + (gens[2] + gens[3]))


def test_mesh_and_shapes_are_checked(setup):
    scene, camera, origins = setup
    with pytest.raises(ValueError, match="needs 6 devices"):
        default_mesh(3, 2, CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            default_mesh()
    fn = make_sharded_wave_renderer(scene, camera, UniformSampler(1),
                                    PathParams(2), TD, default_mesh(
                                        5, 1, CPU8[:5]))
    with pytest.raises(ValueError, match="do not divide"):
        fn(origins, 0, 1)
    with pytest.raises(ValueError, match="samples axis"):
        make_sharded_wave_renderer(scene, camera, UniformSampler(1),
                                   PathParams(2), TD,
                                   default_mesh(4, 2, CPU8), 1)
    with pytest.raises(ValueError, match="unsupported"):
        make_sharded_wave_renderer(scene, camera, UniformSampler(1),
                                   "geometry_normals", TD,
                                   default_mesh(1, 1, CPU8[:1]))(
            origins, 0, 1)
    assert scene_to(scene, "cpu") is scene


def test_scene_copied_once(setup, monkeypatch):
    """The scene is copied once to each distinct device when the renderer
    is made, never on a call: two waves through a 4-tiles mesh copy nothing
    more, and each gives the single-device tiles."""
    import yuki_tpu_torch.parallel as par

    scene, camera, origins = setup
    copies = []
    real = par.scene_to

    def spy(sc, dv):
        copies.append(dv)
        return real(sc, dv)

    monkeypatch.setattr(par, "scene_to", spy)
    sampler, integ = UniformSampler(1), PathParams(max_depth=2)
    fn = make_sharded_wave_renderer(scene, camera, sampler, integ, TD,
                                    default_mesh(4, 1, CPU8[:4]))
    assert copies == [torch.device("cpu")]
    for idx in (0, 1):
        ref, ref_rays = single(setup, sampler, integ, idx, 3)
        px, rays = fn(origins, idx, 3)
        assert torch.equal(px, ref) and float(rays) == float(ref_rays)
    assert len(copies) == 1
