"""The CUDA kernels of the dense wave against their plain PyTorch versions,
on the card.  Marked ``cuda``: they skip where torch.cuda.is_available()
is False.  This file imports no JAX (the machine with the card has none),
so on the card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Both sides run on the same card: the kernel per thread, the plain version
as torch ops.  Products, sums, divisions and square roots round the same
way in both (the kernel is built with -fmad=false, the plain version
takes a correctly rounded sqrt); cos/sin/log may differ by an ulp between
libdevice and torch's CUDA kernels, hence rtol 2e-6 / atol 1e-7 on the
float planes rather than equality.
"""

import numpy as np
import pytest
import torch

from yuki_tpu_torch import transforms as tf
from yuki_tpu_torch.camera import Camera, CameraParameters, FoV
from yuki_tpu_torch.integrators import PathParams
from yuki_tpu_torch.ops import path_fused as tpf
from yuki_tpu_torch.scene.cornell import cornell
from yuki_tpu_torch.scene.data import SceneBuilder

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)

N = 768
RES = (64, 48)
DEPTH = 5
FLOATS = ("ox", "oy", "oz", "dx", "dy", "dz", "bx", "by", "bz",
          "rx", "ry", "rz")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _every_branch_scene(device):
    """All four light types and all four material families (sigma matte,
    glass, metal, glossy) plus a sphere: every runtime branch of the
    bounce kernel."""
    b = SceneBuilder("every-branch")
    floor = b.add_matte(kd=(0.6, 0.55, 0.5), sigma=0.35)
    wall = b.add_glossy(rs=(0.4, 0.5, 0.6), roughness=0.2)
    glass = b.add_glass(eta=1.45)
    metal = b.add_metal(eta=(0.2, 0.9, 1.1), k=(3.9, 2.4, 2.2),
                        roughness=0.05)
    s = 4.0
    b.add_mesh(tf.Transform.identity(), [0, 1, 2, 0, 2, 3],
               [(-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s)],
               material=floor)
    b.add_mesh(tf.Transform.identity(), [0, 1, 2, 0, 2, 3],
               [(-s, 0, -s), (-s, 3, -s), (s, 3, -s), (s, 0, -s)],
               material=wall)
    b.add_mesh(tf.translation((-1.0, 0.0, 0.0)),
               [0, 1, 2, 0, 2, 3, 4, 6, 5, 4, 7, 6, 0, 4, 5, 0, 5, 1],
               [(-.5, 0, -.5), (.5, 0, -.5), (.5, 0, .5), (-.5, 0, .5),
                (-.5, 1, -.5), (.5, 1, -.5), (.5, 1, .5), (-.5, 1, .5)],
               material=glass)
    b.add_sphere(tf.translation((1.2, 0.6, 0.3)), 0.6, metal)
    b.add_point_light(tf.translation((0.5, 2.5, 1.5)), (4.0, 3.5, 3.0))
    b.add_spot_light(tf.translation((-2.0, 2.8, 2.0)), (9.0, 9.0, 10.0),
                     total_width_deg=35.0, falloff_start_deg=25.0)
    b.add_rect_light(tf.translation((0.0, 2.9, 0.0)), (6.0, 6.0, 5.0),
                     (1.0, 1.0))
    b.add_distant_light((0.6, 0.6, 0.7), (0.3, 1.0, 0.4))
    cam = CameraParameters(position=(0.0, 1.5, 5.0), target=(0.0, 0.7, 0.0),
                           fov=FoV.x(60.0))
    return b.build(device=device), cam


def _setup(name, device, clamp=None):
    if name == "cornell":
        scene, cam, _ = cornell(device=device)
    else:
        scene, cam = _every_branch_scene(device)
    tb = tpf.make_tables(scene, Camera.create(cam, *RES),
                         PathParams(DEPTH, indirect_clamp=clamp))
    rng = np.random.default_rng(3)
    px = torch.as_tensor(rng.integers(0, RES[0], N, dtype=np.int32),
                         device=device)
    py = torch.as_tensor(rng.integers(0, RES[1], N, dtype=np.int32),
                         device=device)
    return tb, px, py


def _plane(st, k):
    return st[tpf._ST[k]].cpu().numpy()


CASES = [("cornell", None), ("every-branch", None), ("cornell", 2.0)]


@pytest.mark.parametrize("name", ["cornell", "every-branch"])
def test_raygen_kernel_matches_plain(cuda, name):
    tb, px, py = _setup(name, cuda)
    st_k, ph_k = tpf.raygen_trace(px, py, 5, 2 ** 31 + 9, tb)
    st_p, ph_p = tpf.raygen_trace_plain(px, py, 5, 2 ** 31 + 9, tb)
    torch.cuda.synchronize()
    assert torch.equal(ph_k, ph_p)
    for k in ("prim", "sph", "hitf", "alive", "rc"):
        np.testing.assert_array_equal(_plane(st_k, k), _plane(st_p, k), k)
    for k in ("ox", "oy", "oz", "dx", "dy", "dz", "t", "b0", "b1"):
        np.testing.assert_allclose(_plane(st_k, k), _plane(st_p, k),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name,clamp", CASES)
def test_bounce_kernel_matches_plain(cuda, name, clamp):
    """Every bounce of a wave, each from the same input state."""
    tb, px, py = _setup(name, cuda, clamp)
    st, ph = tpf.raygen_trace(px, py, 1, 7, tb)
    for b in range(DEPTH):
        out_k = tpf.bounce(st, ph, b, tb)
        out_p = tpf.bounce_plain(st, ph, b, tb)
        torch.cuda.synchronize()
        for k in ("alive", "spec", "rc"):
            np.testing.assert_array_equal(_plane(out_k, k), _plane(out_p, k),
                                          f"bounce {b} {k}")
        for k in FLOATS:
            np.testing.assert_allclose(_plane(out_k, k), _plane(out_p, k),
                                       rtol=2e-6, atol=1e-7,
                                       err_msg=f"bounce {b} {k}")
        same = _plane(out_k, "prim") == _plane(out_p, "prim")
        assert same.mean() >= 0.99, f"bounce {b}: next-hit ids differ"
        st = out_k


@pytest.mark.parametrize("name,clamp", CASES)
def test_wave_kernel_matches_plain(cuda, name, clamp):
    """A whole wave: radiance and ray counts under the chaos-aware bounds
    of tests/test_path_fused.py:58-81 (ulps flip a few deep rays)."""
    tb, px, py = _setup(name, cuda, clamp)
    tpf.reset_launches()
    li_k, rc_k = tpf.path_li_wave(tb, px, py, 0, 3)
    assert tpf.LAUNCHES == {"raygen_trace": 1, "bounce": DEPTH, "wave": 0}
    st, ph = tpf.raygen_trace_plain(px, py, 0, 3, tb)
    for b in range(DEPTH):
        st = tpf.bounce_plain(st, ph, b, tb)
    li_p = torch.stack([st[tpf._ST[k]] for k in ("rx", "ry", "rz")], -1)
    rc_p = st[tpf._ST["rc"]]
    got, ref = li_k.cpu().numpy(), li_p.cpu().numpy()
    assert np.isfinite(got).all()
    rays_k, rays_p = float(rc_k.sum()), float(rc_p.sum())
    assert abs(rays_k - rays_p) <= max(16, 0.01 * rays_p)
    bad = (np.abs(got - ref) > 2e-4 + 2e-4 * np.abs(ref)).any(-1)
    assert bad.sum() <= max(4, N // 12)
    np.testing.assert_allclose(got.mean(), ref.mean(), rtol=2e-3)


def test_kernel_wrappers_validate(cuda):
    tb, px, py = _setup("cornell", cuda)
    with pytest.raises(ValueError, match="dtype"):
        tpf.raygen_trace(px.to(torch.int64), py, 0, 0, tb)
    st, ph = tpf.raygen_trace(px, py, 0, 0, tb)
    with pytest.raises(ValueError, match="contiguous"):
        tpf.bounce(st.t().contiguous().t(), ph, 0, tb)
    with pytest.raises(ValueError, match="bounce"):
        tpf.bounce(st, ph, DEPTH, tb)
