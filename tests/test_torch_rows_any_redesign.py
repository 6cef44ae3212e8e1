"""The contract the redesigned occlusion row walk
(yuki_tpu_torch/ops/csrc/trace_rows.cu, ``rows_any_kernel``) rests on,
held on the CPU against the plain version it is compared with on the card.

The TPU kernel (``any_walk``) ORs each group of 8 triangles into every lane
of a 128-ray row and leaves a chunk after the first group at which no lane
that crosses the chunk is still unoccluded.  The kernel computes that exit
in closed form: with S the lanes that cross the chunk unoccluded, the row
leaves after group G, the largest over S of the group of a lane's first
occluder (the last group where one has none), and any other live,
unoccluded lane is occluded if and only if its first occluder lies in
groups 0..G.  A lane's recheck of a chunk is against its t_max, which the
walk never changes, so the kernel rechecks a whole window of list entries
before it walks any, and passes over the entries no lane crosses.
``schedule_walk`` renders that schedule in plain PyTorch (every recheck
first; a row whose S is empty skips the chunk; framed copies tested from
the lane's origin in its frame, up to the chunk's last real row; one max
for G; every live, unoccluded lane walks at once and keeps its verdict
only up to group G).  On hand-built rows (a non-crossing lane whose occluder lies in
group G and one whose occluder lies in G + 1, S all occluded in group 0, a
lane occluded by an earlier chunk, an S emptied by earlier chunks, dead
lanes at t_max 0, -1 and NaN, padding rows between real ones, a skip id
that matches the occluder; leaf sizes 8, 64 and 128; rays along each axis)
and on wide-camera rows that span the three shear frames, it gives
``rows_any_walk_plain``'s bits, and a per-lane exit does not.  Imports no
JAX.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import test_torch_rows_redesign as trr
from torch_scenes import wide_camera
from yuki_tpu_torch import camera as cam_mod
from yuki_tpu_torch import transforms as tf
from yuki_tpu_torch.camera import Camera
from yuki_tpu_torch.ops import trace_rows as trw
from yuki_tpu_torch.ops.trace import ray_shear
from yuki_tpu_torch.scene import data as scene_data

torch.set_num_threads(2)

def schedule_walk(ch, lists, o, d, t_max, skip, per_lane=False):
    """rows_any_kernel's schedule, [N] i32 (1 = occluded); ``per_lane``:
    each lane keeps its own first occluder, with no G (not the TPU's
    bits)."""
    k = ch.leaf_size
    ox, oy, oz, dx, dy, dz, tm = trw._row_planes(o, d, t_max)
    x_max, y_max, sx, sy, inv_dz = ray_shear(dx, dy, dz)
    frame = torch.where(x_max, 1, torch.where(y_max, 2, 0))
    orig = torch.stack([ox, oy, oz], dim=-1)
    of = [torch.gather(orig, 2, torch.as_tensor(trr.FRAMES)[frame][
        ..., j:j + 1])[..., 0] for j in range(3)]
    sk = skip.reshape(tm.shape)
    live = tm > 0.0
    ones = torch.ones_like(tm)
    occ = torch.zeros_like(live)
    tri = ch.rows.reshape(-1, k, 12)
    pid = tri[:, :, 10]
    last = torch.where(pid >= 0.0, torch.arange(1, k + 1), 0).amax(dim=1)
    copies = torch.stack([tri[:, :, :9].reshape(-1, k, 3, 3)[..., list(p)]
                          for p in trr.FRAMES], dim=1)
    rows_idx = torch.arange(k)
    # Every recheck before any walk: [C, rows, 128], entries past a row's
    # first -1 crossing nothing.
    on = torch.cumprod((lists >= 0).long(), dim=1).bool().T
    cross = torch.stack([live & trw._recheck(
        ch.treelet_bounds[tt.long().clamp(min=0)], ox, oy, oz, dx, dy, dz, tm,
        ones) for tt in lists.T]) & on[:, :, None]
    for j in torch.nonzero(cross.any(dim=2).any(dim=1)).squeeze(1).tolist():
        tt = lists[:, j].long()
        crossing = cross[j]
        in_s = crossing & ~occ
        r = torch.nonzero(in_s.any(dim=1)).squeeze(1)
        if r.numel() == 0:
            continue  # the row leaves the chunk before staging it
        c_r = tt[r]
        q = copies[c_r[:, None], frame[r]]  # [R, 128, k, 3, 3]
        ok, ts, det = trr._framed_test(
            (sx[r][..., None], sy[r][..., None], inv_dz[r][..., None]),
            [x[r][..., None] for x in of], q)
        lim = last[c_r][:, None, None]
        blocked = (ok & (ts <= tm[r][..., None] * det)
                   & (tri[c_r, :, 9][:, None, :] != sk[r][..., None])
                   & (pid[c_r][:, None, :] >= 0.0) & (rows_idx < lim))
        # Each lane's first occluder in [0, last), or last.
        rf = torch.where(blocked, rows_idx, k).amin(dim=2)
        rf = torch.minimum(rf, lim[..., 0])
        found = rf < lim[..., 0]
        walker = live[r] & ~occ[r]
        s_r = in_s[r]
        if per_lane:
            occ[r] = occ[r] | (walker & found)
            continue
        g = torch.where(found, rf // 8, k // 8 - 1)
        G = torch.where(s_r, g, -1).amax(dim=1, keepdim=True)
        occ[r] = occ[r] | (walker & found & (rf // 8 <= G))
    return occ.reshape(-1).to(torch.int32)


# ---- hand-built rows --------------------------------------------------

LIVE_T = 1000.0


class Rows:
    """Hand-built chunks and rows of 128 rays along +z from (lane, 10 row,
    0); a triangle at depth z covers one lane's ray."""

    def __init__(self, k):
        self.k = k
        self.chunks = []  # (box x range, [k, 12] rows)
        self.lists = []

    def chunk(self, x_lo, x_hi):
        rows = np.zeros((self.k, 12), np.float32)
        rows[:, 0:9] = 50.0  # far off every ray, padding unless set
        rows[:, 9] = -1.0
        rows[:, 10] = -1.0
        self.chunks.append(((x_lo, x_hi), rows))
        return len(self.chunks) - 1

    def occluder(self, c, r, lane, row, light=-1.0, real=True):
        """Triangle row r of chunk c covers ``lane`` of ``row`` at depth
        1 + r; dropped where r is past the leaf size."""
        if r >= self.k:
            return
        x, y, z = float(lane), 10.0 * row, 1.0 + r
        rows = self.chunks[c][1]
        rows[r, 0:9] = [x - 0.4, y - 0.4, z, x + 0.4, y - 0.4, z, x, y + 0.4, z]
        rows[r, 9] = light
        rows[r, 10] = float(1000 * c + r) if real else -1.0

    def build(self, n_rows, perm):
        """(ch, lists, o, d) with every coordinate permuted by ``perm``
        (rays along x, y or z)."""
        k, n_c = self.k, len(self.chunks)
        rows = np.concatenate([r for _, r in self.chunks])
        corners = rows[:, 0:9].reshape(-1, 3, 3)[..., perm].reshape(-1, 9)
        rows = np.ascontiguousarray(np.concatenate([corners, rows[:, 9:]],
                                                   axis=1))
        bounds = np.zeros((n_c, 8), np.float32)
        for c, ((lo, hi), _) in enumerate(self.chunks):
            box = np.array([[lo, -1000.0, 0.5], [hi, 1000.0, 500.0]],
                           np.float32)
            bounds[c, 0:6] = box[:, perm].reshape(-1)
        width = max(len(x) for x in self.lists)
        lists = np.full((n_rows, width), -1, np.int32)
        for i, entry in enumerate(self.lists):
            lists[i, :len(entry)] = entry
        lane = np.arange(128 * n_rows)
        o = np.stack([lane % 128, 10.0 * (lane // 128), np.zeros_like(
            lane)], axis=1).astype(np.float32)[:, perm]
        d = np.tile(np.array([0.0, 0.0, 1.0], np.float32)[perm],
                    (lane.size, 1))
        ch = SimpleNamespace(n_treelets=n_c, leaf_size=k,
                             treelet_bounds=torch.as_tensor(bounds),
                             rows=torch.as_tensor(rows).contiguous())
        return (ch, torch.as_tensor(lists), torch.as_tensor(
            np.ascontiguousarray(o)), torch.as_tensor(np.ascontiguousarray(d)))


def hand_built(k, perm):
    """The rows of the module docstring, and the verdicts expected of
    chosen lanes: {(row, lane): occluded}."""
    b = Rows(k)
    t_max = np.full(128 * 6, LIVE_T, np.float32)
    skip = np.full(128 * 6, -2.0, np.float32)
    want = {}
    # Row 0: S = lanes 0-3 (lane 4 dead in the box); their first occluders
    # in groups 1, 0, 1, 0, so G = 1.
    a = b.chunk(-0.5, 4.5)
    for lane, r in ((0, 10), (1, 1), (2, 9), (3, 2), (4, 0)):
        b.occluder(a, r, lane, 0)
    t_max[4] = math.nan
    b.occluder(a, 12, 10, 0)   # group G: occluded
    b.occluder(a, 17, 11, 0)   # group G + 1: not occluded
    b.occluder(a, 7, 11, 0, real=False)  # padding between real rows
    b.occluder(a, 15, 11, 0, real=False)
    b.occluder(a, 3, 12, 0)    # group 0: occluded
    b.occluder(a, 4, 13, 0, light=5.0)   # its skip light's: passed over
    b.occluder(a, 20, 13, 0)   # group 2
    b.occluder(a, 5, 14, 0, light=5.0)
    b.occluder(a, 11, 14, 0)   # group 1: occluded
    skip[[13, 14]] = 5.0
    for lane, t in ((20, 0.0), (21, -1.0), (22, math.nan)):
        b.occluder(a, 6, lane, 0)
        t_max[lane] = t
    b.lists.append([a])
    if k >= 24:
        want.update({(0, 0): 1, (0, 4): 0, (0, 10): 1, (0, 11): 0,
                     (0, 12): 1, (0, 13): 0, (0, 14): 1, (0, 20): 0,
                     (0, 21): 0, (0, 22): 0})
    # Row 1: S all occluded in group 0, so G = 0.
    c1 = b.chunk(-0.5, 3.5)
    for lane in range(4):
        b.occluder(c1, lane, lane, 1)
    b.occluder(c1, 8, 10, 1)   # group 1: not occluded
    b.occluder(c1, 5, 11, 1)   # group 0: occluded
    b.lists.append([c1])
    want.update({(1, 11): 1, (1, 0): 1})
    if k >= 16:
        want[(1, 10)] = 0
    # Row 2: lane 0 occluded by an earlier chunk; in the next one S = lanes
    # 1-3, of which two have no occluder, so the row walks every group.
    c2, c3 = b.chunk(-0.5, 0.5), b.chunk(-0.5, 3.5)
    b.occluder(c2, 0, 0, 2)
    b.occluder(c2, 3, 10, 2)
    b.occluder(c3, 0, 0, 2)
    b.occluder(c3, 8, 1, 2)
    b.occluder(c3, k - 3, 11, 2)
    b.lists.append([c2, c3])
    want.update({(2, 0): 1, (2, 10): 1, (2, 11): 1, (2, 2): 0})
    # Row 3: earlier chunks occlude every lane that crosses the last, so the
    # row skips it and lane 10 keeps no occlusion.
    c4, c5 = b.chunk(-0.5, 3.5), b.chunk(-0.5, 3.5)
    for lane in range(4):
        b.occluder(c4, lane, lane, 3)
    b.occluder(c5, 0, 10, 3)
    b.lists.append([c4, c5])
    want.update({(3, 10): 0, (3, 3): 1})
    # Row 4: every lane dead (t_max 0, -1, NaN in turn) under row 0's chunk.
    t_max[512:640] = np.array([0.0, -1.0, math.nan], np.float32)[
        np.arange(128) % 3]
    b.lists.append([a])
    # Row 5: lists end at once (no entry).
    b.lists.append([-1])
    ch, lists, o, d = b.build(6, perm)
    return (ch, lists, o, d, torch.as_tensor(t_max), torch.as_tensor(skip),
            want)


@pytest.mark.parametrize("perm", [(0, 1, 2), (1, 2, 0), (2, 0, 1)],
                         ids=["z", "x", "y"])
@pytest.mark.parametrize("k", [8, 64, 128])
def test_schedule_matches_plain_on_hand_built_rows(k, perm):
    ch, lists, o, d, t_max, skip, want = hand_built(k, list(perm))
    ref = trw.rows_any_walk_plain(ch, lists, o, d, t_max, skip)
    got = schedule_walk(ch, lists, o, d, t_max, skip)
    assert torch.equal(got, ref)
    for (row, lane), occ in want.items():
        assert int(ref[128 * row + lane]) == occ, (row, lane)
    assert int(ref[512:768].sum()) == 0
    if k >= 24:  # lane 11's occluder in group G + 1 tells the exits apart
        per_lane = schedule_walk(ch, lists, o, d, t_max, skip, per_lane=True)
        assert not torch.equal(per_lane, ref)


# ---- wide-camera rows ---------------------------------------------------

@pytest.fixture(scope="module")
def wide():
    """The wide camera's scene (1500 triangles) and its film-order rays,
    as test_torch_rows_redesign.py makes them."""
    scene, cam = wide_camera(scene_data, tf, cam_mod, 1500, 0, seed=3,
                             device="cpu")
    py, px = torch.meshgrid(torch.arange(trr.H), torch.arange(trr.W),
                            indexing="ij")
    p = torch.stack([px.reshape(-1), py.reshape(-1)], -1).float() + 0.5
    o, d = Camera.create(cam, trr.W, trr.H).ray(p)
    return scene, o.contiguous(), d.contiguous()


@pytest.mark.parametrize("k", [8, 64, 128])
def test_schedule_matches_plain_on_wide_camera_rows(wide, k):
    """Rows that span the three shear frames, chunks whose padding rows
    (given real geometry) sit between real ones, dead and NaN lanes, a
    t_max that leaves some lanes unoccluded, and skip ids that match every
    triangle (light -1) or none."""
    scene, o, d = wide
    ch = trr._chunks(scene, k, seed=k)
    n = o.shape[0]
    t_max = torch.where(trr._t_max(n) > 0.0, 3.5, trr._t_max(n))
    lists, _ = trw.kept_lists(trw.row_words_interval(ch, o, d, t_max), 160,
                              160)
    rng = np.random.default_rng(k)
    skip = torch.as_tensor(rng.choice([-2.0, -1.0], n, p=[0.85, 0.15])
                           .astype(np.float32))
    ref = trw.rows_any_walk_plain(ch, lists, o, d, t_max, skip)
    assert torch.equal(schedule_walk(ch, lists, o, d, t_max, skip), ref)
    live = t_max > 0.0
    assert 0 < int(ref[live].sum()) < int(live.sum())
    assert int(ref[~live].sum()) == 0
