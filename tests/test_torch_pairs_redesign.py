"""The contract the redesigned block-pair walks
(yuki_tpu_torch/ops/csrc/trace_pairs.cu, ``pairs_closest_kernel`` and
``pairs_any_kernel``) rest on, held on the CPU against the plain versions
they are compared with on the card.

The semantics are a block's: a 1024-lane block visits a pair's treelet
when some lane's slab test of its box passes at that lane's running t
(closest) or t_max (occlusion, unoccluded lanes only), padding lanes
included, and then every lane tests its rows in order.  The kernels'
schedules, rendered here in plain PyTorch:

- closest (``closest_schedule``): every lane votes on a window of 32
  pairs at its current t; the pairs no lane votes for are passed over (a
  vote can only turn from true to false as t falls); a pair of the window
  is voted again at its turn by the lanes that took a hit since the
  window's vote; a visited treelet's rows are tested in each lane's shear
  frame from its framed origin, up to the treelet's last real row, by the
  lanes with t > 0 only, the divide only for a test that passes its sign,
  det and range tests, b0 and b1 only on a take;
- occlusion (``any_schedule``): the crossing bits of a window at t_max;
  per visited treelet, every unoccluded lane walks to its first blocker,
  r* is the maximum over S (crossing, unoccluded; every row if one of S
  has none), and a lane outside S keeps its blocker only within rows
  0..r* (the same as testing rows 0..r* alone); the blocking test is
  watertight9's hit, whose range test passes at t_max NaN; lanes with
  t_max <= 0 and a finite shear and origin test nothing, and a block whose
  lanes are all occluded or such leaves its list.

Both give the plain versions' bits on ``hand_built`` blocks (BLOCKS: an
axis-parallel lane that fails its own slab and takes a hit in a treelet
visited for others, equal t in two treelets, a take inside a window that
closes a later pair of the window, dead lanes at t_max 0, -1 and NaN, a
skip id matching the only occluder, non-crossing lanes blocked before and
after r*, a ragged block whose only yes vote is a padding lane's, lanes
over the three shear frames, runs of one pair and of more than a window)
at leaf sizes 16 and 64, with a treelet of 2 real rows and one with a
padding row between real ones.  Each wrong schedule differs: no vote
again after a take, non-crossing lanes walked past r*, and the
``ts <= t_max * det`` form of the blocking test on the NaN lane.  Imports
no JAX; the card test (tests/test_torch_cuda_pairs.py) holds the kernels
to the same blocks.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from yuki_tpu_torch.ops import trace_pairs as tpp
from yuki_tpu_torch.ops.trace import F32_MAX, ray_shear
from yuki_tpu_torch.ops.trace_treelets import _slab

torch.set_num_threads(2)

BLOCK = tpp.BLOCK
WINDOW = 32  # pairs the kernels vote on together
FRAMES = ((0, 1, 2), (1, 2, 0), (2, 0, 1))  # z, x, y dominant: (x, y, z) order
BLOCKS = ("axis_tie", "window_take", "dead", "skip", "r_star", "random",
          "one_pair", "padding")
N_RAYS = (len(BLOCKS) - 1) * BLOCK + 300  # the last block is ragged


def _normalize(v):
    v = np.asarray(v, np.float64)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _big(z, x0=0.0, y0=0.0, h=4.0):
    """A big triangle in the plane z around (x0, y0)."""
    return [(x0 - h, y0 - h, z), (x0 + h, y0 - h, z), (x0, y0 + h + 1, z)]


def hand_built(k, seed=0, device="cpu"):
    """Treelets of leaf size k and the ray blocks of BLOCKS.  Returns (tl,
    runs [9] i32, pair_treelet i32, o, d, t_max, chord, skip f32, cases):
    t_max is F32_MAX (0, -1 and NaN for the dead lanes), chord a finite
    t_max for the occlusion walk (the dead lanes' kept), skip the lanes'
    light ids to pass over (-2: none), cases the lanes each case is about
    ({name: ray indices})."""
    rng = np.random.default_rng(seed)
    rows, boxes = [], []

    def treelet(tris, prims, lights=None, box=None, gap=False):
        r = np.zeros((k, 12), np.float32)
        r[:, 9:11] = -1.0
        slots = list(range(len(tris)))
        if gap:  # a padding row between real ones
            slots = [s if s < 1 else s + 1 for s in slots]
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

    # Random clusters of triangles with honest boxes, in all directions;
    # "below" ones (z < -1.5) are the case blocks' fillers, which no case
    # lane's ray (towards +z) crosses.
    clusters, below = [], []
    n_tris = min(k - 1, 12)
    for c in range(64):
        centre = _normalize(rng.standard_normal(3)) * rng.uniform(3.0, 6.0)
        if c % 2:
            centre[2] = -abs(centre[2]) - 2.0
        m = 2 if c == 5 else n_tris
        tris = (centre + rng.normal(0.0, 0.4, (m, 1, 3))
                + rng.uniform(-0.7, 0.7, (m, 3, 3)))
        lights = rng.choice([-1.0, -1.0, 0.0, 1.0], m).tolist()
        clusters.append(treelet(tris, list(range(1000 + 20 * c,
                                                  1000 + 20 * c + m)),
                                lights, gap=c == 7))
        if centre[2] < -1.5:
            below.append(clusters[-1])
    # axis_tie: a big triangle at z = 2 whose box starts at x = 0.5, the
    # axis lane's x (0 * inf = NaN: its own slab fails); the same triangle
    # at z = 1.5 in two treelets (prims 50, 51): the first in list order
    # wins.
    ax = treelet([_big(2.0)], [40], box=(0.5, -4, 1.9, 4, 5, 2.1))
    tie_tri = _big(1.5, x0=-1.0, h=1.0)
    tie = [treelet([tie_tri], [50]), treelet([tie_tri], [51])]
    # window_take: a near triangle at z = 2, then a treelet whose box (z in
    # [5, 6]) passes at t_max and fails at t = 2, though its triangle (z =
    # 1.5) would be hit: walked, it would win.  hidden2: the same in the
    # next window.
    near = treelet([_big(2.0)], [60])
    hidden = treelet([_big(1.5)], [61], box=(-1, -1, 5, 1, 1, 6))
    hidden2 = treelet([_big(1.4)], [62], box=(-1, -1, 5, 1, 1, 6))
    # dead: a blocker at z = 2 that the live lanes cross.
    occ = treelet([_big(2.0, h=1.0)], [70])
    # skip: the only occluder (z = 1) belongs to light 0.
    lit = treelet([_big(1.0, h=1.0)], [80], lights=[0.0])
    # r_star: rows 0 (blocks lane a), 5 (b, outside the box), 7 (a2), 10
    # (c, outside); the box holds a's and a2's paths only, so S = {a, a2},
    # r* = 7: b is occluded, c is not.
    small = lambda x, y, z: [(x - .2, y - .2, z), (x + .2, y - .2, z),  # noqa
                             (x, y + .3, z)]
    rs_rows = {0: small(0, 0, 2), 5: small(3, 0, 2), 7: small(.5, .5, 2),
               10: small(-3, 0, 2)}
    rs_rows = {r: t for r, t in rs_rows.items() if r < k}
    n_rs = max(rs_rows) + 1
    rs = treelet([rs_rows.get(r, small(9, 9, -9)) for r in range(n_rs)],
                 [90 + r if r in rs_rows else -1 for r in range(n_rs)],
                 box=(-1, -1, 1.5, 1, 1, 2.5))
    # padding: a box around the origin, which only the padding lanes
    # (origin 0, t_max 0) are in; the axis lane at x = 0.3 fails its own
    # slab and hits the treelet's triangle at z = 0.
    pad = treelet([_big(0.0, h=1.0)], [100], box=(-.3, -.3, -.3, .3, .3, .3))

    o = np.zeros((N_RAYS, 3), np.float32)
    d = np.zeros((N_RAYS, 3), np.float32)
    d[:, 2] = 1.0
    t_max = np.full(N_RAYS, F32_MAX, np.float32)
    chord = np.full(N_RAYS, np.nan, np.float32)  # set below
    skip = rng.choice([-2.0, 0.0, 1.0], N_RAYS).astype(np.float32)
    runs, pt, cases = [0], [], {}

    def lanes(b, lo, hi):
        return np.arange(b * BLOCK + lo, b * BLOCK + hi)

    def aim(idx, targets, spread=0.2):
        """Lanes idx from near the origin at random real rows' centroids of
        the treelets ``targets``."""
        o[idx] = rng.uniform(-spread, spread, (idx.size, 3))
        tt = rng.choice(targets, idx.size)
        cen = np.stack([rows[c][rng.choice(np.nonzero(rows[c][:, 10] >= 0)[0]),
                                :9].reshape(3, 3).mean(0) for c in tt])
        d[idx] = _normalize(cen + rng.normal(0, 0.05, (idx.size, 3)) - o[idx])

    def block(b, run, fill_from=64):
        """Block b walks ``run``; its lanes from fill_from on aim at the
        run's "below" clusters (or every cluster of the run)."""
        pt.extend(run)
        runs.append(len(pt))
        own = [c for c in run if c in below] or [c for c in run
                                                 if c in clusters]
        n = min(BLOCK, N_RAYS - b * BLOCK)
        if own and fill_from < n:
            aim(lanes(b, fill_from, n), own)

    def fillers(m, pool=None):
        pool = below if pool is None else pool
        return list(rng.choice(pool, m, replace=False))

    b = BLOCKS.index("axis_tie")
    block(b, [ax] + fillers(3) + tie + fillers(4))
    o[lanes(b, 0, 1)] = (0.5, 0.1, 0.0)  # the axis lane
    o[lanes(b, 1, 32)] = np.stack([np.linspace(1.0, 3.0, 31),
                                   np.zeros(31), np.zeros(31)], 1)
    o[lanes(b, 32, 64)] = np.stack([np.linspace(-1.5, -0.5, 32),
                                    np.zeros(32), np.zeros(32)], 1)
    cases["axis"] = lanes(b, 0, 1)
    cases["tie"] = lanes(b, 32, 64)
    b = BLOCKS.index("window_take")
    run = fillers(3) + [near] + fillers(4) + [hidden] + fillers(24)
    run += fillers(8) + [hidden2] + fillers(3)
    block(b, run, fill_from=512)
    idx = lanes(b, 0, 512)
    o[idx] = rng.uniform(-0.3, 0.3, (512, 3)) * (1, 1, 0)
    d[idx] = _normalize(np.stack([0.02 * o[idx, 0], 0.02 * o[idx, 1],
                                  np.ones(512)], 1))
    cases["window_take"] = idx
    b = BLOCKS.index("dead")
    block(b, fillers(2) + [occ] + fillers(6))
    idx = lanes(b, 0, 64)
    o[idx] = rng.uniform(-0.5, 0.5, (64, 3)) * (1, 1, 0)
    t_max[idx[:3]] = (0.0, -1.0, np.nan)
    t_max[idx[3:64:8]] = np.nan
    t_max[lanes(b, 64, 200)[::5]] = np.resize([0.0, -1.0], 28)
    cases["nan"] = idx[t_max[idx] != t_max[idx]]
    b = BLOCKS.index("skip")
    block(b, fillers(3) + [lit] + fillers(3))
    idx = lanes(b, 0, 64)
    o[idx] = rng.uniform(-0.5, 0.5, (64, 3)) * (1, 1, 0)
    skip[idx] = np.where(np.arange(64) % 2 == 0, 0.0, -2.0)
    cases["skip"] = idx
    b = BLOCKS.index("r_star")
    block(b, fillers(2) + [rs] + fillers(2), fill_from=4)
    a, a2, bb, c = lanes(b, 0, 4)
    o[[a, a2, bb, c]] = [(0, 0, 0), (.5, .5, 0), (3, 0, 0), (-3, 0, 0)]
    cases["r_star"] = np.array([a, a2, bb, c])
    b = BLOCKS.index("random")
    run = fillers(WINDOW + 14, clusters)
    run[3] = clusters[5]  # 2 real rows
    run[9] = clusters[7]  # a padding row between real ones
    block(b, run, fill_from=0)
    b = BLOCKS.index("one_pair")
    block(b, [clusters[2]], fill_from=0)
    b = BLOCKS.index("padding")
    block(b, [pad] + fillers(3))
    idx = lanes(b, 0, 300)
    o[idx] = rng.uniform(-0.2, 0.2, (300, 3)) + (0, 0, -10)
    d[idx] = _normalize(rng.uniform(-0.3, 0.3, (300, 3)) - (0, 0, 1))
    o[idx[0]] = (0.3, 0.0, -10.0)
    d[idx[0]] = (0.0, 0.0, 1.0)
    cases["padding"] = idx[:1]

    dead = ~(t_max > 0.0)
    chord = np.where(dead, t_max, rng.uniform(1.0, 6.0, N_RAYS))
    chord[cases["r_star"]] = 5.0
    chord[cases["padding"]] = 20.0
    chord[cases["window_take"]] = 8.0
    dev = torch.device(device)
    tl = SimpleNamespace(n_treelets=len(rows), leaf_size=k,
                         treelet_bounds=torch.as_tensor(np.stack(boxes),
                                                        device=dev),
                         rows=torch.as_tensor(np.concatenate(rows),
                                              device=dev))
    ints = [torch.as_tensor(np.asarray(x, np.int32), device=dev)
            for x in (runs, pt)]
    floats = [torch.as_tensor(np.asarray(x, np.float32), device=dev)
              for x in (o, d, t_max, chord, skip)]
    return (tl, *ints, *floats, cases)


def packed_tables(hb):
    """The closest walk's and the occlusion walk's packed rays."""
    tl, runs, pt, o, d, t_max, chord, skip, _ = hb
    nb = runs.shape[0] - 1
    return (tpp._pack_rays(o, d, t_max, nb),
            tpp._pack_rays(o, d, chord, nb, skip))


# --------------------------------------------------------------------
# The kernels' schedules, in plain PyTorch
# --------------------------------------------------------------------


class _Block:
    """A block's lanes: origin, 1 / d, shear and frame, framed origin."""

    def __init__(self, planes, b):
        ox, oy, oz, dx, dy, dz = (p[b] for p in planes[:6])
        self.o = (ox, oy, oz)
        self.inv = tuple(torch.reciprocal(x) for x in (dx, dy, dz))
        x_max, y_max, self.sx, self.sy, self.inv_dz = ray_shear(dx, dy, dz)
        self.frame = torch.where(x_max, 1, torch.where(y_max, 2, 0))
        o = torch.stack([ox, oy, oz], 1)
        self.of = torch.gather(o, 1, torch.as_tensor(FRAMES)[self.frame])

    def vote(self, box, t):
        return _slab(box[:6, None], *self.o, *self.inv, t)

    def terms(self, rows, at):
        """The t-independent part of the framed test of ``rows`` [R, 12]
        for lanes ``at``: (ok, det, t_scaled, e0, e1), each [R, len(at)]
        (ok: the sign and det tests pass)."""
        corners = rows[:, :9].reshape(-1, 3, 3)
        copies = torch.stack([corners[:, :, list(p)] for p in FRAMES], 1)
        q = copies[:, self.frame[at]]  # [R, M, 3 corners, 3]
        of = self.of[at]
        sx, sy, inv_dz = self.sx[at], self.sy[at], self.inv_dz[at]
        p0tx, p0ty, p0tz = (q[:, :, 0, a] - of[:, a] for a in range(3))
        p1tx, p1ty, p1tz = (q[:, :, 1, a] - of[:, a] for a in range(3))
        p2tx, p2ty, p2tz = (q[:, :, 2, a] - of[:, a] for a in range(3))
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
        t_scaled = (e0 * p0tz + e1 * p1tz + e2 * p2tz) * inv_dz
        return ~miss_sign & (det != 0.0), det, t_scaled, e0, e1

    def finite(self):
        s = (self.of.sum(1) + self.sx + self.sy + self.inv_dz)
        return torch.isfinite(s)


def _in_range(det, t_scaled, t):
    """watertight9's range test, a miss test, against t."""
    neg = det < 0.0
    bound = t * det
    return ~((neg & ((t_scaled >= 0.0) | (t_scaled < bound)))
             | (~neg & ((t_scaled <= 0.0) | (t_scaled > bound))))


def _le_form(det, t_scaled, t):
    """The divide-free form the slot walks' first_occluder uses: the signs
    folded so that det > 0, then ts > 0 and ts <= t * det (false at t
    NaN, where watertight9's miss test passes)."""
    neg = det < 0.0
    ts, dt = torch.where(neg, -t_scaled, t_scaled), torch.where(neg, -det, det)
    return (ts > 0.0) & (ts <= t * dt)


def _last_real(rows):
    pid = rows[:, 10]
    real = torch.nonzero(pid >= 0.0)
    return int(real[-1]) + 1 if real.numel() else 0


def closest_schedule(tl, runs, pt, packed, revote=True):
    """pairs_closest_kernel's schedule: (t, prim i32, b0, b1) over the
    blocks' lanes, as pairs_closest_plain returns them.  ``revote`` False:
    the window's bits stand after a take (wrong)."""
    nb = runs.shape[0] - 1
    planes = tpp._block_planes(packed, nb)
    k = tl.leaf_size
    rows = tl.rows.reshape(tl.n_treelets, k, -1)
    out_t = planes[6].clone()
    out_p = torch.full_like(out_t, -1, dtype=torch.int32)
    out_b0, out_b1 = torch.zeros_like(out_t), torch.zeros_like(out_t)
    for b in range(nb):
        ln = _Block(planes, b)
        t, prim, b0, b1 = out_t[b], out_p[b], out_b0[b], out_b1[b]
        live = torch.nonzero(t > 0.0).squeeze(1)
        q0, q1 = int(runs[b]), int(runs[b + 1])
        for base in range(q0, q1, WINDOW):
            tts = pt[base:min(base + WINDOW, q1)].long()
            bits = torch.stack([ln.vote(tl.treelet_bounds[tt], t)
                                for tt in tts])
            took = torch.zeros(BLOCK, dtype=torch.bool)
            for j in torch.nonzero(bits.any(dim=1)).squeeze(1).tolist():
                box = tl.treelet_bounds[tts[j]]
                v = (torch.where(took, ln.vote(box, t), bits[j]) if revote
                     else bits[j])
                if not bool(v.any()):
                    continue
                tri = rows[tts[j]]
                last = _last_real(tri)
                ok, det, t_scaled, e0, e1 = ln.terms(tri[:last], live)
                for r in range(last):
                    at = live
                    passed = ok[r] & _in_range(det[r], t_scaled[r], t[at])
                    p = torch.nonzero(passed).squeeze(1)
                    inv_det = torch.reciprocal(det[r, p])
                    ti = t_scaled[r, p] * inv_det
                    take = (ti < t[at[p]]) & (tri[r, 10] >= 0.0)
                    win = at[p[take]]
                    t[win] = ti[take]
                    prim[win] = int(tri[r, 10])
                    b0[win] = e0[r, p[take]] * inv_det[take]
                    b1[win] = e1[r, p[take]] * inv_det[take]
                    took[win] = True
    return (out_t.reshape(-1), out_p.reshape(-1), out_b0.reshape(-1),
            out_b1.reshape(-1))


def any_schedule(tl, runs, pt, packed, past_r_star=False, le_form=False):
    """pairs_any_kernel's schedule: [n_blocks * 1024] bool.
    ``past_r_star``: the non-crossing lanes walk every real row (wrong);
    ``le_form``: the blocking test's range part as ``ts <= t_max * det``
    (wrong at t_max NaN)."""
    nb = runs.shape[0] - 1
    planes = tpp._block_planes(packed, nb)
    k = tl.leaf_size
    rows = tl.rows.reshape(tl.n_treelets, k, -1)
    occ_all = torch.zeros(nb, BLOCK, dtype=torch.bool)
    in_range = _le_form if le_form else _in_range
    for b in range(nb):
        ln = _Block(planes, b)
        tm, sk = planes[6][b], planes[7][b]
        may = ~(tm <= 0.0) | ~ln.finite()
        occ = occ_all[b]
        q0, q1 = int(runs[b]), int(runs[b + 1])
        for base in range(q0, q1, WINDOW):
            if not bool((may & ~occ).any()):
                break
            tts = pt[base:min(base + WINDOW, q1)].long()
            cross = torch.stack([ln.vote(tl.treelet_bounds[tt], tm)
                                 for tt in tts])
            mask = (cross & ~occ).any(dim=1)
            for j in torch.nonzero(mask).squeeze(1).tolist():
                in_s = cross[j] & ~occ
                if not bool(in_s.any()):
                    continue
                tri = rows[tts[j]]
                last = _last_real(tri)
                at = torch.nonzero(may & ~occ).squeeze(1)
                ok, det, t_scaled = ln.terms(tri[:last], at)[:3]
                blocked = (ok & in_range(det, t_scaled, tm[at])
                           & (tri[:last, 9, None] != sk[at])
                           & (tri[:last, 10, None] >= 0.0))
                first = torch.where(blocked.any(dim=0),
                                    blocked.to(torch.int32).argmax(dim=0),
                                    k)
                rf = torch.full((BLOCK,), k)
                rf[at] = first
                r_star = int(torch.where(in_s, rf, -1).max())
                cap = last if past_r_star else min(r_star + 1, last)
                other = may & ~occ & ~in_s
                occ |= (in_s & (rf < k)) | (other & (rf < cap))
    return occ_all.reshape(-1)


def _equal(got, ref):
    return all(torch.equal(g.view(torch.int32), r.view(torch.int32))
               for g, r in zip(got, ref))


@pytest.fixture(scope="module", params=[16, 64])
def built(request):
    hb = hand_built(request.param)
    return hb, packed_tables(hb)


def test_closest_schedule_matches_plain(built):
    (tl, runs, pt, *_, cases), (packed, _) = built
    ref = tpp.pairs_closest_plain(tl, runs, pt, packed)
    assert _equal(closest_schedule(tl, runs, pt, packed), ref)
    t, prim = ref[:2]
    # The axis lane fails its own slab of the first treelet and takes its
    # triangle; the tie goes to the first treelet in list order.
    a = int(cases["axis"][0])
    assert int(prim[a]) == 40
    assert bool((prim[cases["tie"]] == 50).all())
    # The ragged block: the axis lane takes the treelet only the padding
    # lanes vote for; NaN lanes never take.
    assert int(prim[int(cases["padding"][0])]) == 100
    assert bool((prim[cases["nan"]] == -1).all())
    assert bool((prim[cases["window_take"]] == 60).all())


def test_own_slabs_fail_where_the_block_visits(built):
    """The axis lane's and the padding case's own slabs of the treelet
    they take fail (NaN), in the ragged block only padding lanes vote for
    that treelet, and the random block's lanes span the three frames."""
    (tl, runs, pt, o, d, t_max, *_, cases), (packed, _) = built
    for case, b in (("axis", "axis_tie"), ("padding", "padding")):
        lane = int(cases[case][0])
        box = tl.treelet_bounds[int(pt[int(runs[BLOCKS.index(b)])])]
        inv = torch.reciprocal(d[lane])
        assert not bool(_slab(box[:6], *o[lane], *inv, t_max[lane]))
    b = BLOCKS.index("random")
    frame = _Block(tpp._block_planes(packed, len(BLOCKS)), b).frame
    assert set(frame.tolist()) == {0, 1, 2}
    b = BLOCKS.index("padding")
    pad_box = tl.treelet_bounds[int(pt[int(runs[b])])]
    real = slice(b * BLOCK, N_RAYS)
    inv = torch.reciprocal(d[real])
    votes = _slab(pad_box[:6, None], *o[real].T, *inv.T, t_max[real])
    assert not bool(votes.any())
    assert bool(_slab(pad_box[:6], 0.0, 0.0, 0.0, 1.0, 1.0, 1.0,
                      torch.tensor(0.0)))


def test_any_schedule_matches_plain(built):
    (tl, runs, pt, *_, cases), (_, packed) = built
    ref = tpp.pairs_any_plain(tl, runs, pt, packed)
    assert torch.equal(any_schedule(tl, runs, pt, packed), ref)
    a, a2, b, c = cases["r_star"].tolist()
    assert ref[a] and ref[a2] and ref[b] and not ref[c]
    assert bool(ref[cases["nan"]].all())
    sk = cases["skip"]
    assert not bool(ref[sk[0::2]].any()) and bool(ref[sk[1::2]].all())
    assert bool(ref[int(cases["padding"][0])])


def test_wrong_schedules_differ(built):
    (tl, runs, pt, *_, cases), (packed, packed_any) = built
    ref = tpp.pairs_closest_plain(tl, runs, pt, packed)
    got = closest_schedule(tl, runs, pt, packed, revote=False)
    assert not _equal(got, ref)
    assert not bool((got[1][cases["window_take"]] == 60).all())
    ref = tpp.pairs_any_plain(tl, runs, pt, packed_any)
    past = any_schedule(tl, runs, pt, packed_any, past_r_star=True)
    assert bool(past[int(cases["r_star"][3])]) and not torch.equal(past, ref)
    le = any_schedule(tl, runs, pt, packed_any, le_form=True)
    assert not bool(le[cases["nan"]].any()) and not torch.equal(le, ref)
