"""The contract the redesigned bundle walks
(yuki_tpu_torch/ops/csrc/trace_walker.cu, ``walker_closest_kernel`` and
``walker_any_kernel``) rest on, held on the CPU against the plain versions
they are compared with on the card.

The closest walk keeps one carry (ts, det, prim) per ray and triangle
slot and decides each list entry in list order: a ray is live for it when
t_max > 0 and its box test passes at its bound, the minimum over the 128
slots of ts / det.  The kernel (one warp a bundle) rechecks a window of 16
entries at the current bounds, walks the first entry with a live ray and,
only after a walk in which a slot took a hit, makes the bounds again (the
same divides) and rechecks the rest of the window before it chooses the
next entry: every entry after the walked one when some bound rose, else
only those that still have a live ray (min(tf, bound) never grows as a
bound falls).  ``closest_schedule`` renders that schedule in plain
PyTorch (rows in each ray's shear frame, tested from its framed origin,
the walk cut at the chunk's last real row); without the recheck after a
take (``recheck_after_take=False``) it walks an entry the bound has
closed and differs.  The occlusion walk's bits are the OR of
schedule-free verdicts: ``any_schedule`` rechecks windows at t_max, walks
the crossed entries in another order than the list's, 32 rows at a time,
and retires each ray at its first occluder.  Both give the plain versions'
bits on ``hand_built`` bundles (a tie within a slot across two entries, a
bound that shrinks inside a window and one that shrinks before the next
window, dead rays at t_max 0, -1 and NaN, a skip id that matches the
nearest hit and the only occluder, padding rows between real ones, rays
over all three shear frames and along each axis, an empty list and a full
one) at leaf sizes 8, 64 and 128.  Imports no JAX; the card test
(tests/test_torch_cuda_walker.py) holds the kernels to the same bundles.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import test_torch_rows_redesign as trr
from yuki_tpu_torch.ops import trace_walker as tw
from yuki_tpu_torch.ops.trace import F32_MAX, ray_shear

torch.set_num_threads(2)

BUN = 8
WINDOW = 16  # list entries the closest kernel rechecks together
SLOTS = 128
C = 20
# The bundles of hand_built, in order.
BUNDLES = ("tie", "shrink", "shrink_next_window", "dead", "skip", "axes",
           "empty", "full") + tuple(f"random{i}" for i in range(8))


def _normalize(v):
    v = np.asarray(v, np.float64)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def hand_built(k, seed=0, device="cpu"):
    """Chunks of leaf size k and 16 bundles (BUNDLES) for the walks' edge
    cases.  Returns (ch, lists [16, C] i32, o, d, t_max, skip, chord):
    t_max is F32_MAX (0, -1 and NaN for the dead rays), chord a finite
    t_max for the occlusion walk (the dead rays' kept), skip the rays'
    light ids to pass over (-2: none)."""
    rng = np.random.default_rng(seed)
    rows, boxes = [], []

    def chunk(tris, prims, lights=None, slots=None, box=None):
        r = np.zeros((k, 12), np.float32)
        r[:, 9:11] = -1.0
        # Real rows at the slots not 1 mod 3: padding between real ones.
        slots = slots or [s for s in range(k) if s % 3 != 1][:len(tris)]
        lights = [-1.0] * len(tris) if lights is None else lights
        for s, t, p, lt in zip(slots, tris, prims, lights):
            r[s, :9] = np.asarray(t, np.float32).reshape(9)
            r[s, 9], r[s, 10] = lt, p
        pts = np.asarray(tris, np.float32).reshape(-1, 3)
        b = np.zeros(8, np.float32)
        b[:3], b[3:6] = pts.min(0), pts.max(0)
        if box is not None:
            b[:6] = box
        rows.append(r)
        boxes.append(b)
        return len(rows) - 1

    big_z = lambda z: [(-4, -4, z), (4, -4, z), (0, 5, z)]  # noqa: E731
    # tie: the same triangle in slots 1 (prim 5) and 3 (prim 2) of one chunk
    # and slot 1 (prim 1) of the next; slot 1 keeps the first in list order.
    tri = [(0, 0, 0.5), (1, 0, 0.5), (0, 1, 0.5)]
    tie = [chunk([tri, tri], [5, 2], slots=[1, 3]),
           chunk([tri], [1], slots=[1])]
    # shrink: a near triangle at z = 2, then a chunk whose box (z in [5, 6])
    # passes at t_max and fails at the bound 2, though its triangle (z =
    # 1.5) would be hit: walked, it would win.
    near = chunk([big_z(2.0)], [10])
    hidden = chunk([big_z(1.5)], [11], box=(-1, -1, 5, 1, 1, 6))
    # Random clusters of triangles with honest boxes, in all directions.
    clusters, behind = [], []  # behind: clusters at z < -1.5
    n_tris = min(len([s for s in range(k) if s % 3 != 1]), 24)
    for c in range(24):
        centre = _normalize(rng.standard_normal(3)) * rng.uniform(3.0, 6.0)
        cen = centre + rng.normal(0.0, 0.4, (n_tris, 1, 3))
        tris = cen + rng.uniform(-0.7, 0.7, (n_tris, 3, 3))
        lights = rng.choice([-1.0, -1.0, 0.0, 1.0], n_tris).tolist()
        clusters.append(chunk(tris, list(range(100 + 40 * c,
                                              100 + 40 * c + n_tris)),
                              lights))
        if centre[2] < -1.5:
            behind.append(clusters[-1])
    # skip: the nearest triangle (z = 1) belongs to light 0, a farther one
    # (z = 3) to no light.
    lit = chunk([big_z(1.0)], [20], lights=[0.0])
    far = chunk([big_z(3.0)], [21])
    # axes: big triangles across each axis at distance 3; the -y one's
    # box has lo x = lo z = 0, the origin's x and z.
    axes = []
    for a in range(3):
        for s in (1.0, -1.0):
            t = np.array([(-3, -3, 0), (3, -3, 0), (0, 4, 0)], np.float32)
            t = np.roll(t, a + 1, axis=1)
            t[:, a] = 3.0 * s
            axes.append(chunk([t], [30 + len(axes)]))
    rows[axes[3]][0, :9] = np.array([(0, -3, 0), (0, -3, 3), (3, -3, 0)],
                                    np.float32).reshape(9)
    boxes[axes[3]][:6] = (0, -3, 0, 3, -3, 3)
    assert len(behind) >= 3

    n_b = len(BUNDLES)
    o = np.zeros((n_b * BUN, 3), np.float32)
    d = np.zeros((n_b * BUN, 3), np.float32)
    d[:, 2] = 1.0
    t_max = np.full(n_b * BUN, F32_MAX, np.float32)
    skip = np.full(n_b * BUN, -2.0, np.float32)
    lists = np.full((n_b, C), -1, np.int32)
    r8 = np.arange(BUN)

    def rays(b):
        return slice(BUN * b, BUN * b + BUN)

    def aim(b, targets):
        """Rays of bundle b from near the origin at the centroids of random
        triangles of the chunks ``targets``."""
        sl = rays(b)
        o[sl] = rng.uniform(-0.2, 0.2, (BUN, 3))
        ch = rng.choice(targets, BUN)
        cen = np.stack([rows[c][rng.choice(np.nonzero(rows[c][:, 10] >= 0)[0]),
                                :9].reshape(3, 3).mean(0) for c in ch])
        d[sl] = _normalize(cen + rng.normal(0, 0.05, (BUN, 3)) - o[sl])

    b = BUNDLES.index("tie")
    o[rays(b)] = np.stack([0.3 + 0.04 * r8, np.full(BUN, 0.3),
                           np.full(BUN, -1.0)], 1)
    lists[b, :2] = tie
    b = BUNDLES.index("shrink")
    o[rays(b)] = rng.uniform(-0.3, 0.3, (BUN, 3)) * (1, 1, 0)
    d[rays(b)] = _normalize(np.stack([0.05 * o[rays(b), 0],
                                      0.05 * o[rays(b), 1],
                                      np.ones(BUN)], 1))
    lists[b, :3] = [near, hidden, behind[0]]
    b = BUNDLES.index("shrink_next_window")
    o[rays(b)] = o[rays(b - 1)]
    d[rays(b)] = d[rays(b - 1)]
    lists[b, :18] = sorted(rng.choice(clusters, 18, replace=False))
    lists[b, :3] = behind[:3]
    lists[b, 2], lists[b, 17] = near, hidden
    b = BUNDLES.index("dead")
    aim(b, clusters[:6])
    lists[b, :6] = clusters[:6]
    t_max[BUN * b:BUN * b + 3] = (0.0, -1.0, np.nan)
    b = BUNDLES.index("skip")
    o[rays(b)] = rng.uniform(-0.3, 0.3, (BUN, 3)) * (1, 1, 0)
    skip[rays(b)] = np.where(r8 % 2 == 0, 0.0, -2.0)
    lists[b, :2] = [lit, far]
    b = BUNDLES.index("axes")
    d[rays(b)] = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
                  (0, 0, -1), _normalize((1, 0.9, 0.2)),
                  _normalize((0.1, -0.7, 0.6))]
    lists[b, :6] = axes
    b = BUNDLES.index("full")
    aim(b, clusters[:C])
    lists[b] = sorted(clusters[:C])
    for i in range(8):
        b = BUNDLES.index(f"random{i}")
        own = sorted(rng.choice(clusters, rng.integers(3, 12), replace=False))
        aim(b, own)
        lists[b, :len(own)] = own
        skip[rays(b)] = rng.choice([-2.0, 0.0, 1.0], BUN)
    dead = ~(t_max > 0.0)
    chord = np.where(dead, t_max, rng.uniform(1.0, 6.0, t_max.shape)
                     ).astype(np.float32)
    dev = torch.device(device)
    ch = SimpleNamespace(n_treelets=len(rows), leaf_size=k,
                         treelet_bounds=torch.as_tensor(np.stack(boxes),
                                                        device=dev),
                         rows=torch.as_tensor(np.concatenate(rows),
                                              device=dev))
    return (ch, torch.as_tensor(lists, device=dev),
            *(torch.as_tensor(x, device=dev)
              for x in (o, d, t_max, skip, chord)))


def _frame(d):
    ad = d.abs()
    x_max = (ad[:, 0] > ad[:, 1]) & (ad[:, 0] > ad[:, 2])
    y_max = ~x_max & (ad[:, 1] > ad[:, 2])
    return torch.where(x_max, 1, torch.where(y_max, 2, 0))


def framed_hits(ch, chunk, o, d):
    """Rays o, d [R, 3] against chunk's rows up to its last real one (the
    kernels' ``walk_rows``), each
    row read in the ray's shear frame and tested from the ray's origin in
    that frame (watertight_framed): (ok, ts, det) [R, n], light, pid [n]."""
    k = ch.leaf_size
    tri = ch.rows[chunk * k:chunk * k + int(tw.walk_rows(ch)[chunk])]
    _, _, sx, sy, inv_dz = ray_shear(d[:, 0], d[:, 1], d[:, 2])
    perm = torch.as_tensor(trr.FRAMES)[_frame(d)]  # [R, 3]
    corners = tri[:, :9].reshape(-1, 3, 3)
    framed = corners[None].expand(o.shape[0], -1, -1, -1).gather(
        3, perm[:, None, None, :].expand(-1, tri.shape[0], 3, 3))
    of = o.gather(1, perm)
    ok, ts, det = trr._framed_test((sx[:, None], sy[:, None], inv_dz[:, None]),
                                   [of[:, a:a + 1] for a in range(3)], framed)
    return ok, ts, det, tri[:, 9], tri[:, 10]


def _window(ch, lst, base, o, d, tm, bound, lo=0):
    """A window's entries (up to the list's end) and each one's live rays
    [WINDOW, 8] at ``bound``, entries before ``lo`` left out."""
    ent = lst[base:base + WINDOW]
    n_on = next((e for e, t in enumerate(ent) if t < 0), len(ent))
    live = torch.zeros((WINDOW, BUN), dtype=torch.bool)
    for e in range(lo, n_on):
        box = ch.treelet_bounds[ent[e]][None]
        live[e] = (tm > 0.0) & tw._bounds_recheck(
            box, *(x[None] for x in (o[:, 0], o[:, 1], o[:, 2], d[:, 0],
                                     d[:, 1], d[:, 2], bound)))[0]
    return ent, n_on, live


def closest_schedule(ch, lists, o, d, t_max, skip=None,
                     recheck_after_take=True):
    """walker_closest_kernel's schedule: (t [N], prim [N] i32)."""
    n_c = lists.shape[1]
    t_out = t_max.clone()
    p_out = torch.full_like(t_max, -1, dtype=torch.int32)
    for b in range(lists.shape[0]):
        sl = slice(BUN * b, BUN * b + BUN)
        ro, rd, tm = o[sl], d[sl], t_max[sl]
        lst = lists[b].tolist()
        if not bool((tm > 0.0).any()) or n_c == 0 or lst[0] < 0:
            continue
        ts = tm[:, None].repeat(1, SLOTS)
        det = torch.ones_like(ts)
        prim = torch.full_like(ts, -1.0)
        bound = tm.clone()
        for base in range(0, n_c, WINDOW):
            ent, n_on, live = _window(ch, lst, base, ro, rd, tm, bound)
            e = 0
            while True:
                todo = [x for x in range(e, n_on) if bool(live[x].any())]
                if not todo:
                    break
                eb = todo[0]
                e = eb + 1
                m = live[eb]
                ok, ts_c, det_c, light, pid = framed_hits(ch, ent[eb], ro, rd)
                n = ts_c.shape[1]
                closer = (ok & m[:, None] & (pid >= 0.0)
                          & (ts_c * det[:, :n] < ts[:, :n] * det_c))
                if skip is not None:
                    closer = closer & (light != skip[sl][:, None])
                ts[:, :n] = torch.where(closer, ts_c, ts[:, :n])
                det[:, :n] = torch.where(closer, det_c, det[:, :n])
                prim[:, :n] = torch.where(closer, pid.expand_as(ts_c),
                                          prim[:, :n])
                if not bool(closer.any()) or not recheck_after_take:
                    continue
                # The bounds read back after a take; the rest of the window
                # rechecked, only its still-live entries when none rose.
                nb = (ts / det).amin(dim=1)
                rose = bool((nb > bound).any())
                bound = nb
                keep = live[eb + 1:n_on].any(dim=1)
                _, _, again = _window(ch, lst, base, ro, rd, tm, bound,
                                      lo=eb + 1)
                if not rose:
                    again[eb + 1:n_on] &= keep[:, None]
                live = again
            if n_on < WINDOW:
                break
        t, p = tw._fold_closest(ts[None], det[None], prim[None], tm[None])
        t_out[sl], p_out[sl] = t[0], p[0]
    return t_out, p_out


def any_schedule(ch, lists, o, d, t_max, skip, seed=0):
    """walker_any_kernel's verdicts, with the crossed entries of each window
    walked in a shuffled order: [N] i32 (1 = occluded)."""
    rng = np.random.default_rng(seed)
    occ_out = torch.zeros_like(t_max, dtype=torch.int32)
    for b in range(lists.shape[0]):
        sl = slice(BUN * b, BUN * b + BUN)
        ro, rd, tm, sk = o[sl], d[sl], t_max[sl], skip[sl]
        lst = lists[b].tolist()
        open_ = tm > 0.0
        occ = torch.zeros_like(open_)
        if not bool(open_.any()) or not lst or lst[0] < 0:
            continue
        for base in range(0, len(lst), WINDOW):
            if not bool(open_.any()):
                break
            ent, n_on, cross = _window(ch, lst, base, ro, rd, tm, tm)
            cross = cross & open_
            crossed = [x for x in range(n_on) if bool(cross[x].any())]
            for eb in rng.permutation(crossed).tolist():
                m = cross[eb] & open_
                ok, ts, det, light, pid = framed_hits(ch, ent[eb], ro, rd)
                hit = (ok & (ts <= tm[:, None] * det) & (light != sk[:, None])
                       & (pid >= 0.0))
                for g in range(0, hit.shape[1], 32):
                    if not bool(m.any()):
                        break
                    now = m & hit[:, g:g + 32].any(dim=1)
                    occ, open_, m = occ | now, open_ & ~now, m & ~now
            if n_on < WINDOW:
                break
        occ_out[sl] = occ.to(torch.int32)
    return occ_out


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.fixture(scope="module", params=[8, 64, 128])
def built(request):
    return hand_built(request.param)


def test_hand_built_covers_the_edges(built):
    """The bundles hold what the module's docstring says they do, and the
    plain walk gives the cases' expected answers."""
    ch, lists, o, d, t_max, skip, chord = built
    k = ch.leaf_size
    pid = ch.rows[:, 10].reshape(-1, k)
    real = pid >= 0.0
    last = torch.where(real, torch.arange(1, k + 1), 0).amax(dim=1)
    assert bool((real.sum(dim=1) < last).any())  # padding between real rows
    assert set(_frame(d).tolist()) == {0, 1, 2}
    assert int((lists[BUNDLES.index("empty")] >= 0).sum()) == 0
    assert int((lists[BUNDLES.index("full")] >= 0).sum()) == C
    assert int((lists[BUNDLES.index("shrink_next_window")] >= 0).sum()) > \
        WINDOW
    dead = t_max[8 * BUNDLES.index("dead"):][:3]
    assert dead[0] == 0.0 and dead[1] == -1.0 and bool(dead[2].isnan())
    t, p = tw.walker_closest_plain(ch, lists, o, d, t_max)

    def of(name):
        return slice(8 * BUNDLES.index(name), 8 * BUNDLES.index(name) + 8)
    assert p[of("tie")].tolist() == [2] * 8  # a running minimum gives 1
    assert p[of("shrink")].tolist() == [10] * 8
    assert p[of("shrink_next_window")].tolist() == [10] * 8
    assert p[of("dead")][:3].tolist() == [-1] * 3
    assert torch.equal(_bits(t[of("dead")][:3]), _bits(t_max[of("dead")][:3]))
    assert p[of("skip")].tolist() == [20] * 8
    assert int((p[of("axes")][:6] >= 30).sum()) >= 5
    assert bool((p >= 0).sum() > 80)
    _, p_s = tw.walker_closest_plain(ch, lists, o, d, t_max, skip=skip)
    assert p_s[of("skip")].tolist() == [21, 20] * 4
    occ = tw.walker_any_plain(ch, lists, o, d, chord, skip)
    assert int(occ[of("dead")][:3].sum()) == 0
    assert 0 < int(occ.sum()) < occ.numel()
    short = torch.where(chord > 0.0, 2.0, chord)
    occ2 = tw.walker_any_plain(ch, lists, o, d, short, skip)
    assert occ2[of("skip")].tolist() == [0, 1] * 4  # skip matches the only occluder


@pytest.mark.parametrize("with_skip", [False, True])
def test_closest_schedule_matches_plain(built, with_skip):
    ch, lists, o, d, t_max, skip, _ = built
    sk = skip if with_skip else None
    got = closest_schedule(ch, lists, o, d, t_max, sk)
    ref = tw.walker_closest_plain(ch, lists, o, d, t_max, skip=sk)
    assert torch.equal(_bits(got[0]), _bits(ref[0]))
    assert torch.equal(got[1], ref[1])


def test_any_schedule_matches_plain(built):
    ch, lists, o, d, _, skip, chord = built
    ref = tw.walker_any_plain(ch, lists, o, d, chord, skip)
    for seed in (0, 1):
        assert torch.equal(any_schedule(ch, lists, o, d, chord, skip, seed),
                           ref)


def test_schedule_without_the_recheck_after_a_take_differs(built):
    """Without the recheck after a take, the shrinking bundle walks the
    hidden chunk at its old bound and takes its nearer triangle."""
    ch, lists, o, d, t_max, _, _ = built
    ref = tw.walker_closest_plain(ch, lists, o, d, t_max)
    bad = closest_schedule(ch, lists, o, d, t_max, recheck_after_take=False)
    b = BUNDLES.index("shrink")
    assert bad[1][8 * b:8 * b + 8].tolist() == [11] * 8
    assert ref[1][8 * b:8 * b + 8].tolist() == [10] * 8
    assert not torch.equal(bad[1], ref[1])


def test_walk_rows_is_each_chunks_last_real_row(built):
    """The kernels' table of rows to walk: each chunk's last real row,
    kept on the chunk structure and rebuilt when its rows change."""
    ch = built[0]
    k = ch.leaf_size
    n = tw.walk_rows(ch)
    pid = ch.rows[:, 10].reshape(-1, k)
    for c in range(ch.n_treelets):
        real = torch.nonzero(pid[c] >= 0.0).squeeze(1)
        assert int(n[c]) == (int(real.max()) + 1 if real.numel() else 0)
    assert n.dtype == torch.int32 and tw.walk_rows(ch) is n
    rows = ch.rows.clone()
    try:
        ch.rows[k - 1, 10] = 7.0  # chunk 0's last row becomes real
        assert int(tw.walk_rows(ch)[0]) == k
    finally:
        ch.rows.copy_(rows)
    assert torch.equal(tw.walk_rows(ch), n)
