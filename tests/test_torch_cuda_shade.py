"""The shade kernel against its plain PyTorch version at edge shapes, on
the card: one lane, whole 512-lane runs of one class, every lane dead, a
ragged wave mixing dead lanes and every class, and the stratified
sampler's planes.  Marked ``cuda``: they skip where
torch.cuda.is_available() is False.  This file imports no JAX, so on the
card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_shade.py

Every plane is held as chip_smoke.py holds it: the flag planes (alive2,
spec2, each light's worth) bit for bit, the others to rtol 2e-6 / atol
1e-7 (cos/sin/log ulps between libdevice and torch's CUDA kernels); and
the kernel on its lanes permuted, permuted back, gives its own bits.
"""

import numpy as np
import pytest
import torch

from torch_scenes import REDUCED
from yuki_tpu_torch import traverse
from yuki_tpu_torch.camera import Camera
from yuki_tpu_torch.integrators import PathParams
from yuki_tpu_torch.ops import shade_fused as tsf
from yuki_tpu_torch.ops.trace import F32_MAX
from yuki_tpu_torch.scene.testscenes import colonnade

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)

RES = (64, 48)


@pytest.fixture(scope="module")
def wave():
    """A pool of 8192 lanes of the reduced colonnade: camera rays, a tenth
    of them turned into random directions (spheres, missed lanes), their
    hits, random beta and specular flags, a fifth dead; the tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    scene, cam, _ = colonnade(device=dev, **REDUCED)
    tb = tsf.make_shade_tables(scene, PathParams(5))
    n = 8192
    rng = np.random.default_rng(17)
    camera = Camera.create(cam, *RES)
    o, d = camera.ray(torch.as_tensor(rng.random((n, 2), np.float32)
                                      * np.array(RES, np.float32), device=dev))
    o, d = o.contiguous().clone(), d.contiguous().clone()
    k = n // 10
    dd = rng.standard_normal((k, 3)).astype(np.float32)
    d[:k] = torch.as_tensor(dd / np.linalg.norm(dd, axis=1, keepdims=True),
                            device=dev)
    hit = traverse.intersect(scene.data, scene.meta, o, d,
                             torch.full((n,), F32_MAX, device=dev))
    alive = hit.hit & torch.as_tensor(rng.random(n) >= 0.2, device=dev)
    beta = torch.as_tensor(rng.random((n, 3), np.float32) + 0.1, device=dev)
    spec = torch.as_tensor(rng.random(n) < 0.3, device=dev)
    rh, prim = tsf.pack_shade(hit, o, d, beta, alive, spec)
    ph = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
                         .astype(np.int32), device=dev)
    return tb, rh.contiguous(), prim, ph, rng


def lane_class(tb, rh, prim):
    """A lane's class: 0 dead, else 1 + 2 mtype + 1 on a sphere."""
    alive = rh[tsf._RH["alive"]] > 0.0
    sph = rh[tsf._RH["sph"]]
    mid = tb.trs[prim.clamp(min=0).long(), 26]
    si = sph.clamp(0, max(tb.n_spheres - 1, 0)).long()
    on = (sph >= 0.0) & (sph < tb.n_spheres) & (si.float() == sph)
    mid = torch.where(on, tb.sp[si, 34], mid)
    mtype = tb.mat[mid.clamp(min=0.0).long(), 0].long().clamp(0, 3)
    return torch.where(alive, 1 + 2 * mtype + on.long(), 0)


def check_planes(tb, got, ref):
    flags = [tsf._OUT["alive2"], tsf._OUT["spec2"]] + [
        tsf._N_FIXED_OUT + tsf._N_PER_LIGHT * li + 7
        for li in range(tb.n_lights)]
    for p in flags:
        assert torch.equal(got[p], ref[p]), f"plane {p}"
    torch.testing.assert_close(got, ref, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["one-lane", "one-class-tile", "all-dead",
                                  "mixed", "strat"])
@pytest.mark.parametrize("bounce", [0, 4])
def test_shade_edge_shapes(wave, case, bounce):
    tb, rh, prim, ph, rng = wave
    cls = lane_class(tb, rh, prim)
    n = rh.shape[1]
    if case == "one-lane":
        sel = torch.tensor([int(torch.nonzero(cls > 0)[0])], device=rh.device)
    elif case == "one-class-tile":
        top = int(torch.bincount(cls[cls > 0]).argmax())
        sel = torch.nonzero(cls == top).squeeze(1)[:1024]
        assert sel.numel() == 1024  # 1024 lanes of one class
    elif case == "all-dead":
        sel = torch.arange(1000, device=rh.device)
    else:
        sel = torch.arange(n - 5, device=rh.device)  # a ragged last tile
    r = rh[:, sel].contiguous()
    if case == "all-dead":
        r[tsf._RH["alive"]] = 0.0
    p, h = prim[sel].contiguous(), ph[sel].contiguous()
    m = sel.numel()
    spl = None
    if case == "strat":
        spl = torch.as_tensor(rng.random((2 * tb.n_lights + 3, m),
                                         np.float32), device=rh.device)
    dim0 = 2 + bounce * (2 * tb.n_lights + 3)
    tsf.reset_launches()
    got = tsf.shade_planes(tb, r, p, h, None, dim0, bounce, spl)
    ref = tsf.shade_planes_plain(tb, r, p, h, None, dim0, bounce, spl)
    torch.cuda.synchronize()
    assert tsf.LAUNCHES["shade"] == 1
    check_planes(tb, got, ref)
    c = lane_class(tb, r, p)
    if case == "one-class-tile":
        assert int(c.unique().numel()) == 1
    if case in ("mixed", "strat"):
        assert int((torch.bincount(c) > 0).sum()) >= 4  # dead + 3 live
        # The kernel on its lanes in another order keeps its own bits.
        perm = torch.as_tensor(rng.permutation(m), device=rh.device)
        inv = torch.argsort(perm)
        got_p = tsf.shade_planes(
            tb, r[:, perm].contiguous(), p[perm].contiguous(),
            h[perm].contiguous(), None, dim0, bounce,
            None if spl is None else spl[:, perm].contiguous())
        assert torch.equal(got_p[:, inv].view(torch.int32),
                           got.view(torch.int32))
