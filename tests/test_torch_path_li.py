"""The port's treelet path end to end: make_wave_renderer -> camera rays
-> integrators.path_li (treelet walk, spheres, shade, occlusion walk,
resolve per bounce) on the CPU, held against yuki_tpu's make_wave_renderer
on the reduced colonnade with its fused shade kernels in Pallas interpret
mode (on the CPU yuki_tpu traverses with intersect_bvh, an exact query
over the same watertight test), under _assert_parity's bounds with equal
ray counts at every depth; plus the renderer's gates: what they route to
path_li and what they refuse."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from yuki_tpu_torch import transforms as tf
from yuki_tpu_torch.camera import Camera
from yuki_tpu_torch.integrators import PathParams
from yuki_tpu_torch.ops import path_fused as tpf
from yuki_tpu_torch.ops import shade_fused as tsf
from yuki_tpu_torch.ops import trace_treelets as ttt
from yuki_tpu_torch.renderer import make_wave_renderer
from yuki_tpu_torch.sampling import UniformSampler
from yuki_tpu_torch.scene.data import DENSE_TRI_THRESHOLD, SceneBuilder

torch.set_num_threads(2)


@pytest.mark.parametrize("depth", [1, 3, 5])
def test_path_li_matches_jax_reduced_colonnade(depth):
    ref, rays_ref, got, rays_got = tp.render_path_li_both("reduced", depth)
    assert np.isfinite(got).all() and got.mean() > 0
    assert rays_got == rays_ref
    tp.assert_parity(ref, rays_ref, got, rays_got, depth)


@pytest.mark.parametrize("depth", [1, 3])
def test_path_li_stratified_matches_jax_reduced_colonnade(depth):
    """StratifiedSampler(2, 2) through path_li: each bounce's 2L+3 values
    computed by the sampler and read by the shade kernel as planes, as
    yuki_tpu's shade_fused hoists them."""
    ref, rays_ref, got, rays_got = tp.render_path_li_both("reduced", depth,
                                                          strat=(2, 2))
    assert np.isfinite(got).all() and got.mean() > 0
    assert rays_got == rays_ref
    tp.assert_parity(ref, rays_ref, got, rays_got, depth)


def test_cpu_path_counts_no_launches():
    scene, cam = tp.port_scene("reduced")
    for m in (tpf, tsf, ttt):
        m.reset_launches()
    render = make_wave_renderer(scene, Camera.create(cam, *tp.RES),
                                UniformSampler(1), PathParams(2), tp.TD, 2)
    px, rays = render(tp.ORIGINS[:2], 0, 1)
    assert px.shape == (2, tp.TD, tp.TD, 3) and float(rays) > 0
    assert tpf.LAUNCHES == {"raygen_trace": 0, "bounce": 0, "wave": 0}
    assert tsf.LAUNCHES == {"shade": 0, "resolve": 0}
    assert ttt.LAUNCHES == {"treelet_closest": 0, "treelet_any": 0}


def _soup_scene(n_tris, sphere_tex=False):
    rng = np.random.default_rng(0)
    b = SceneBuilder("soup")
    m = b.add_matte(kd=(0.5, 0.5, 0.5))
    pts = (rng.random((3 * n_tris, 3)) * 4 - 2).astype(np.float32)
    b.add_mesh(tf.Transform.identity(), np.arange(3 * n_tris), pts,
               material=m)
    if sphere_tex:
        tex = b.add_texture(np.full((2, 2, 3), 0.5, np.float32))
        b.add_sphere(tf.translation((0, 0, 0)), 0.5,
                     b.add_matte(kd_tex=tex))
    b.add_point_light(tf.translation((0, 3, 0)), (1.0, 1.0, 1.0))
    return b.build(device="cpu")


def test_gates_raise():
    from yuki_tpu_torch.sampling import StratifiedSampler

    camera = Camera.create(tp.port_scene("reduced")[1], *tp.RES)

    def mwr(scene, sampler=UniformSampler(1)):
        return make_wave_renderer(scene, camera, sampler, PathParams(5),
                                  tp.TD, tp.TILES)

    # Dense, past the fused wave's 1024: path_li over the dense sweeps.
    dense_band = _soup_scene(2000)
    assert dense_band.meta.traversal == "dense"
    assert not tpf.wave_supported(dense_band.meta, UniformSampler(1))
    px, rays = mwr(dense_band)(tp.ORIGINS[:1], 0, 1)
    assert px.shape == (1, tp.TD, tp.TD, 3) and torch.isfinite(px).all()
    assert float(rays) >= tp.TD * tp.TD
    textured_sphere = _soup_scene(DENSE_TRI_THRESHOLD + 10, sphere_tex=True)
    assert textured_sphere.meta.traversal == "treelet"
    with pytest.raises(NotImplementedError,
                       match=r"the XLA shading chain \(surface\.py, "
                       r"bsdf\.py, lights\.py\), which is not ported"):
        mwr(textured_sphere)
    # The stratified sampler is accepted: path_li hands the shade kernel
    # its values as planes.
    reduced, _ = tp.port_scene("reduced")
    px, rays = mwr(reduced, StratifiedSampler(2, 2))(tp.ORIGINS[:1], 0, 1)
    assert px.shape == (1, tp.TD, tp.TD, 3) and torch.isfinite(px).all()
    assert float(rays) >= tp.TD * tp.TD
