"""The contracts the redesigned row-union closest walk
(yuki_tpu_torch/ops/csrc/trace_rows.cu, ``rows_closest_kernel``) rests on,
held on the CPU against the plain version it is compared with on the card.

The kernel's walk, rendered here in plain PyTorch: per 128-ray row and per
list entry in order, every lane rechecks the chunk's box against its own
running best and the row walks the chunk when any live lane passes (the
TPU kernel's block-wide decision); a walked chunk is staged as copies
permuted for the shear frames, and a lane tests its frame's copy from its
origin in that frame, with no selects; the walk stops at the chunk's last
real row rounded up to 8, so triangle r keeps carry r % 8; a 32-lane warp
whose lanes all have t_max <= 0 or NaN skips the walk.  On rows whose
lanes span the three shear frames (``torch_scenes.wide_camera``), chunks
whose padding rows (given geometry that would hit) sit between real rows,
lists that end early or are cut, and dead and NaN lanes, it gives
``rows_closest_walk_plain``'s bits with and without skip; the same walk
cut one row too early does not.  Imports no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_scenes import wide_camera
from yuki_tpu_torch import camera as cam_mod
from yuki_tpu_torch import transforms as tf
from yuki_tpu_torch.camera import Camera
from yuki_tpu_torch.ops import trace_rows as trw
from yuki_tpu_torch.ops.trace import (F32_MAX, ray_shear, scaled_min8)
from yuki_tpu_torch.scene import data as scene_data
from yuki_tpu_torch.treelets import build_treelets

torch.set_num_threads(2)

W, H = 64, 32
FRAMES = ((0, 1, 2), (1, 2, 0), (2, 0, 1))  # z, x, y dominant: (x, y, z) order


@pytest.fixture(scope="module")
def wide():
    """The wide camera's scene (1500 triangles) and its film-order rays."""
    scene, cam = wide_camera(scene_data, tf, cam_mod, 1500, 0, seed=3,
                             device="cpu")
    py, px = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    p = torch.stack([px.reshape(-1), py.reshape(-1)], -1).float() + 0.5
    o, d = Camera.create(cam, W, H).ray(p)
    return scene, o.contiguous(), d.contiguous()


def _chunks(scene, k, seed):
    """The scene's flat chunks of k rows, each chunk's rows in a seeded
    order (padding between real rows) and every padding row given a real
    triangle's corners, still with prim id -1."""
    tris = scene.data.tris
    tri_p = torch.stack([tris.p0, tris.p1, tris.p2], dim=1).numpy()
    ch = build_treelets(scene.bvh_host, tri_p, tris.area_light.numpy(),
                        leaf_size=k, super_size=k, device="cpu")
    g = torch.Generator().manual_seed(seed)
    perm = torch.argsort(torch.rand((ch.n_treelets, k), generator=g), dim=1)
    rows = torch.gather(ch.rows.reshape(-1, k, 12), 1,
                        perm[:, :, None].expand(-1, -1, 12)).reshape(-1, 12)
    pad = rows[:, 10] < 0.0
    real = torch.nonzero(~pad).squeeze(1)
    rows[pad, 0:9] = rows[real[torch.randint(0, real.numel(), (
        int(pad.sum()),), generator=g)], 0:9]
    return dataclasses.replace(ch, rows=rows.contiguous())


def _t_max(n):
    """F32_MAX with every seventh lane 0, every thirteenth -1, the lanes
    of every third row's second warp 0 (a dead warp), and NaN in the
    first row's lanes 5 and 6."""
    t = torch.full((n,), F32_MAX)
    lane = torch.arange(n)
    t[lane % 7 == 3] = 0.0
    t[lane % 13 == 5] = -1.0
    t[((lane // 128) % 3 == 1) & ((lane % 128) // 32 == 1)] = 0.0
    t[5:7] = float("nan")
    return t


def framed_rows_walk(ch, lists, o, d, t_max, skip=None, early=False):
    """rows_closest_kernel's walk, [3, N] (ts, prim, det); ``early``: each
    walk stops one row before the chunk's last real row."""
    k = ch.leaf_size
    ox, oy, oz, dx, dy, dz, tm = trw._row_planes(o, d, t_max)
    x_max, y_max, sx, sy, inv_dz = ray_shear(dx, dy, dz)
    frame = torch.where(x_max, 1, torch.where(y_max, 2, 0))
    orig = torch.stack([ox, oy, oz], dim=-1)
    of = [torch.gather(orig, 2, torch.as_tensor(FRAMES)[frame][..., j:j + 1]
                       )[..., 0] for j in range(3)]
    sk = None if skip is None else skip.reshape(tm.shape)
    live = tm > 0.0
    warp_live = live.reshape(-1, 4, 32).any(dim=2).repeat_interleave(32, 1)
    ts, det = tm.clone(), torch.ones_like(tm)
    prim = torch.full_like(tm, -1.0)
    tri = ch.rows.reshape(-1, k, 12)
    pid = tri[:, :, 10]
    last = torch.where(pid >= 0.0, torch.arange(1, k + 1), 0).amax(dim=1)
    stop = last - 1 if early else (last + 7) // 8 * 8
    # The three copies: corner c's coordinates in frame order.
    copies = torch.stack([tri[:, :, :9].reshape(-1, k, 3, 3)[..., list(p)]
                          for p in FRAMES], dim=1)  # [chunks, 3, k, 3, 3]
    for j in range(lists.shape[1]):
        tt = lists[:, j].long()
        on = tt >= 0
        if not bool(on.any()):
            break
        cb = ch.treelet_bounds[tt.clamp(min=0)]
        near = live & trw._recheck(cb, ox, oy, oz, dx, dy, dz, ts, det)
        r = torch.nonzero(on & near.any(dim=1)).squeeze(1)
        if r.numel() == 0:
            continue
        c_r = tt[r]
        # [R, 128, k, 3, 3]: each lane's frame's copy of its row's chunk
        q = copies[c_r[:, None], frame[r]]
        o_r = [x[r] for x in of]
        s_r = (sx[r], sy[r], inv_dz[r])
        ts_b = ts[r].expand(8, -1, -1).clone()
        det_b = det[r].expand(8, -1, -1).clone()
        prim_b = prim[r].expand(8, -1, -1).clone()
        walks = warp_live[r]
        for row in range(k):
            going = (row < stop[c_r])[:, None] & walks
            c = q[:, :, row]
            ok, ts_c, det_c = _framed_test(s_r, o_r, c)
            p_id = pid[c_r, row][:, None]
            take = (going & ok & (p_id >= 0.0)
                    & (ts_c * det_b[row % 8] < ts_b[row % 8] * det_c))
            if sk is not None:
                take = take & (tri[c_r, row, 9][:, None] != sk[r])
            s = row % 8
            ts_b[s] = torch.where(take, ts_c, ts_b[s])
            det_b[s] = torch.where(take, det_c, det_b[s])
            prim_b[s] = torch.where(take, p_id.expand_as(take), prim_b[s])
        ts[r], det[r], prim[r] = scaled_min8(ts_b, det_b, prim_b)
    return torch.stack([ts.reshape(-1), prim.reshape(-1), det.reshape(-1)])


def _framed_test(shear, of, c):
    """watertight_framed: corners c [..., 3 corners, 3] already in the
    ray's frame, origin ``of`` in that frame; (ok, ts, det) with det > 0."""
    sx, sy, inv_dz = shear
    p0tx, p0ty, p0tz = (c[..., 0, a] - of[a] for a in range(3))
    p1tx, p1ty, p1tz = (c[..., 1, a] - of[a] for a in range(3))
    p2tx, p2ty, p2tz = (c[..., 2, a] - of[a] for a in range(3))
    p0tx = p0tx + sx * p0tz
    p0ty = p0ty + sy * p0tz
    p1tx = p1tx + sx * p1tz
    p1ty = p1ty + sy * p1tz
    p2tx = p2tx + sx * p2tz
    p2ty = p2ty + sy * p2tz
    e0 = p1tx * p2ty - p1ty * p2tx
    e1 = p2tx * p0ty - p2ty * p0tx
    e2 = p0tx * p1ty - p0ty * p1tx
    miss_sign = ((e0 < 0) | (e1 < 0) | (e2 < 0)) & (
        (e0 > 0) | (e1 > 0) | (e2 > 0))
    det = e0 + e1 + e2
    ts = (e0 * p0tz + e1 * p1tz + e2 * p2tz) * inv_dz
    neg = det < 0.0
    ts = torch.where(neg, -ts, ts)
    det = torch.where(neg, -det, det)
    return ~miss_sign & (det != 0.0) & (ts > 0.0), ts, det


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("k,C,mult,skip", [(16, 160, 160, False),
                                           (128, 160, 160, True),
                                           (16, 6, 4, True),
                                           (128, 6, 4, False)])
def test_framed_walk_matches_plain(wide, k, C, mult, skip):
    """The kernel's walk equals rows_closest_walk_plain bit for bit; rows
    span the three shear frames, some chunks' padding is not a tail, lists
    end early (and with (6, 4) are cut and rows are dropped); with whole
    lists, the walk cut one row before each chunk's last real row does
    not."""
    scene, o, d = wide
    ch = _chunks(scene, k, seed=k + C)
    n = o.shape[0]
    t_max = _t_max(n)
    lists, ov = trw.kept_lists(trw.row_words_interval(ch, o, d, t_max), C,
                               mult)
    ends = (lists >= 0).sum(dim=1)
    assert int(ends.min()) < C and int(ends.max()) > 1
    sk = None
    if skip:
        rng = np.random.default_rng(k)
        sk = torch.as_tensor(rng.choice([-2.0, -1.0], n, p=[0.8, 0.2])
                             .astype(np.float32))
    ref = trw.rows_closest_walk_plain(ch, lists, o, d, t_max, skip=sk)
    got = framed_rows_walk(ch, lists, o, d, t_max, sk)
    assert torch.equal(_bits(got), _bits(ref))
    if C == 160:
        early = framed_rows_walk(ch, lists, o, d, t_max, sk, early=True)
        assert not torch.equal(_bits(early), _bits(ref))

    frames = torch.where(ray_shear(*d.T)[0], 1, torch.where(
        ray_shear(*d.T)[1], 2, 0)).reshape(-1, 128)
    mixed = torch.stack([(frames == f).any(dim=1) for f in range(3)]).sum(0)
    assert int((mixed == 3).sum()) > 0
    pid = ch.rows[:, 10].reshape(-1, k)
    last = torch.where(pid >= 0.0, torch.arange(1, k + 1), 0).amax(dim=1)
    assert bool((last > (pid >= 0.0).sum(dim=1)).any())
    dead = ~(t_max > 0.0)
    assert bool(dead.reshape(-1, 32).all(dim=1).any())
    assert bool((got[1][dead] == -1.0).all())
    if C == 160:
        assert int((got[1] >= 0.0).sum()) > n // 4
    else:
        assert bool(ov.any()) and int((got[1] >= 0.0).sum()) > 0
