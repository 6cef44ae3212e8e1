"""The contract the redesigned treelet walks
(yuki_tpu_torch/ops/csrc/trace_treelets.cu, ``treelet_closest_kernel``
and ``treelet_any_kernel``, the dispatch's fallback) rest on, held on the
CPU against the plain versions they are compared with on the card.

The semantics are a block's: a 1024-lane block visits a super, then a
visited super's treelet, when some lane's slab test of its box passes at
that lane's running t (closest) or t_max (occlusion: every lane, occluded
ones too), padding lanes included, and then every lane tests the
treelet's rows in order.  The kernels' schedules, rendered here in plain
PyTorch:

- closest (``closest_schedule``): every lane votes on a window of 32
  supers, and on a window of 32 treelets of a visited super, at its
  current t; the boxes no lane votes for are passed over (a vote can only
  turn from true to false as t falls); a box of the window is voted again
  at its turn by the lanes that took a hit since the window's vote (a take
  can close a later treelet of the window, or a later super); a visited
  treelet's rows are tested in each lane's shear frame from its framed
  origin, up to the treelet's last real row, by the lanes with t > 0 only,
  the divide only for a test that passes its sign, det and range tests, b0
  and b1 only on a take;
- occlusion (``any_schedule``): the votes of a window at t_max by every
  lane, final; per visited treelet each lane that can still be occluded
  tests its rows up to its first blocker (watertight9's hit, whose range
  test passes at t_max NaN); lanes with t_max <= 0 and a finite shear and
  origin test nothing, and the block leaves once every other lane is
  occluded.

Both give the plain versions' bits on ``hand_built`` blocks (BLOCKS: an
axis-parallel lane that fails its own slab and takes a hit in a treelet
visited for others, equal t in two treelets of different supers, a take
inside a window that closes a later treelet of the window, a take that
closes a later super, dead lanes at t_max 0, -1 and NaN, a skip id
matching the only occluder, a treelet opened for the occlusion walk only
by an occluded lane's vote, lanes over the three shear frames, a ragged
last block whose only vote for a treelet is a padding lane's) over 35
supers (two windows), one of 40 treelets, with a treelet of 2 real rows
and one with a padding row between real ones, at leaf sizes 16 and 64.
Each wrong schedule differs: no vote again after a take (at either
level), occluded lanes dropped from the occlusion vote, and a walk cut one
row early.  The kernels launch their blocks most votes first
(``treelet_votes_plain``: each block's treelet votes at t_max inside the
supers it votes for); whole blocks in that order give the same bits.
Imports no JAX; the card test
(tests/test_torch_cuda_treelet.py) holds the kernels to the same blocks.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_pairs_redesign import _Block, _big, _in_range, _last_real
from test_torch_pairs_redesign import _normalize
from yuki_tpu_torch.ops import trace_treelets as ttt
from yuki_tpu_torch.ops.trace import F32_MAX
from yuki_tpu_torch.ops.trace_treelets import _slab

torch.set_num_threads(2)

BLOCK = ttt.BLOCK
WINDOW = 32  # boxes the kernels vote on together
BLOCKS = ("axis_tie", "window_take", "super_take", "dead", "skip",
          "occ_vote", "random", "padding")
N_RAYS = (len(BLOCKS) - 1) * BLOCK + 300  # the last block is ragged
CENTRE = np.array([30.0, 0.0, 0.0])  # the random clusters and lanes
N_CLUSTERS = 70
BIG_SUPER = 40  # treelets of the first super: two windows


def _small(x, y, z):
    return [(x - .2, y - .2, z), (x + .2, y - .2, z), (x, y + .3, z)]


def hand_built(k, seed=0, device="cpu"):
    """Supers, treelets of leaf size k and the ray blocks of BLOCKS.
    Returns (tl, o, d, t_max, chord, skip i32, cases): t_max is F32_MAX
    (0, -1 and NaN for the dead lanes), chord a finite t_max for the
    occlusion walk (the dead lanes' kept), skip the lanes' light ids to
    pass over (-2: none), cases the lanes each case is about ({name: ray
    indices}).  Each case sits in a region of its own (x = 10, y = 10 c),
    the random clusters around CENTRE, the padding lanes' treelet at the
    origin, which no real lane's ray comes near."""
    rng = np.random.default_rng(seed)

    def treelet(tris, prims, lights=None, box=None, gap=False, at=(0, 0, 0)):
        r = np.zeros((k, 12), np.float32)
        r[:, 9:11] = -1.0
        slots = list(range(len(tris)))
        if gap:  # a padding row between real ones
            slots = [s if s < 1 else s + 1 for s in slots]
        lights = [-1.0] * len(tris) if lights is None else lights
        pts = np.asarray(tris, np.float64).reshape(-1, 3) + at
        for s, p, lt, t in zip(slots, prims, lights, pts.reshape(-1, 9)):
            r[s, :9] = t
            r[s, 9], r[s, 10] = lt, p
        b = np.zeros(8, np.float32)
        b[:3], b[3:6] = pts.min(0), pts.max(0)
        if box is not None:
            b[:6] = np.asarray(box, np.float64) + np.tile(at, 2)
        return r, b

    # Random clusters of triangles with honest boxes around CENTRE, in all
    # directions; cluster 5 has 2 real rows, cluster 7 a padding row.
    clusters = []
    n_tris = min(k - 1, 12)
    for c in range(N_CLUSTERS):
        centre = (CENTRE + _normalize(rng.standard_normal(3))
                  * rng.uniform(3.0, 6.0))
        m = 2 if c == 5 else n_tris
        tris = (centre + rng.normal(0.0, 0.4, (m, 1, 3))
                + rng.uniform(-0.7, 0.7, (m, 3, 3)))
        lights = rng.choice([-1.0, -1.0, 0.0, 1.0], m).tolist()
        clusters.append(treelet(tris, list(range(1000 + 20 * c,
                                                  1000 + 20 * c + m)),
                                lights, gap=c == 7))
    off = {name: np.array([10.0, 10.0 * i, 0.0])
           for i, name in enumerate(BLOCKS)}
    # axis_tie: a big triangle at z = 2 whose box starts at x = 0.5, the
    # axis lane's x (0 * inf = NaN: its own slab fails); the same triangle
    # at z = 1.5 in the next treelet (prim 50) and in the next super (51):
    # the first in walk order wins.
    a = off["axis_tie"]
    ax = treelet([_big(2.0)], [40], box=(0.5, -4, 1.9, 4, 5, 2.1), at=a)
    tie_tri = _big(1.5, x0=-1.0, h=1.0)
    tie = [treelet([tie_tri], [50], at=a), treelet([tie_tri], [51], at=a)]
    # window_take: a near triangle at z = 2, then in the same window a
    # treelet whose box (z in [5, 6]) passes at t_max and fails at t = 2,
    # though its triangle (z = 1.5) would be hit: walked, it would win.
    a = off["window_take"]
    near = treelet([_big(2.0)], [60], at=a)
    hidden = treelet([_big(1.5)], [61], box=(-1, -1, 5, 1, 1, 6), at=a)
    # super_take: the same across supers: a super of one near triangle,
    # then a super whose box (z in [5, 6]) fails at t = 2, of a treelet
    # with an honest box around its triangle at z = 1.4.
    a = off["super_take"]
    near2 = treelet([_big(2.0)], [62], at=a)
    hidden2 = treelet([_big(1.4)], [63], at=a)
    hidden2_super = np.array([-1, -1, 5, 1, 1, 6]) + np.tile(a, 2)
    # dead: a blocker at z = 2 that the live lanes cross.
    occ = treelet([_big(2.0, h=1.0)], [70], at=off["dead"])
    # skip: the only occluder (z = 1) belongs to light 0.
    lit = treelet([_big(1.0, h=1.0)], [80], lights=[0.0], at=off["skip"])
    # occ_vote: lane A (slanted) is blocked at z = 2 (prim 110) in one
    # super; a later super and its treelet (a big triangle at z = 3.5,
    # prim 111) have a box that A crosses and that starts at x = -0.5,
    # axis lane B's x: only A, occluded by then, votes for them.
    a = off["occ_vote"]
    blk = treelet([_small(0.1, 0.0, 2.0)], [110], at=a)
    late_box = np.array([-0.5, -2, 3, 1, 2, 4]) + np.tile(a, 2)
    late = treelet([_big(3.5, h=2.0)], [111], box=late_box - np.tile(a, 2),
                   at=a)
    # padding: a box around the origin, which only the padding lanes
    # (origin 0, t_max 0) are in; the axis lane at x = 0.3 fails its own
    # slab and hits the treelet's triangle at z = 0.
    pad_box = (-.3, -.3, -.3, .3, .3, .3)
    pad = treelet([_big(0.0, h=1.0)], [100], box=pad_box)

    # Supers in walk order (name, treelets, box or None for the union).
    supers = [("big", clusters[:BIG_SUPER], None),
              ("axis", [ax, tie[0]], None), ("tie", [tie[1]], None),
              ("window", clusters[40:43] + [near] + clusters[43:45]
               + [hidden] + [clusters[45]], None),
              ("near2", [near2], None), ("hidden2", [hidden2], hidden2_super),
              ("dead", [occ], None), ("skip", [lit], None),
              ("blocker", [blk], None),
              ("late", [late], late_box),
              ("pad", [pad], pad_box)]
    supers += [(f"single{c}", [clusters[c]], None)
               for c in range(46, N_CLUSTERS)]
    rows, tboxes, sboxes, ranges = [], [], [], []
    for _, members, box in supers:
        ranges.append((len(tboxes), len(members)))
        rows += [r for r, _ in members]
        tboxes += [b for _, b in members]
        sb = np.zeros(8, np.float32)
        sb[:3] = np.min([b[:3] for _, b in members], axis=0)
        sb[3:6] = np.max([b[3:6] for _, b in members], axis=0)
        if box is not None:
            sb[:6] = box
        sboxes.append(sb)

    o = np.zeros((N_RAYS, 3), np.float32)
    d = np.zeros((N_RAYS, 3), np.float32)
    d[:, 2] = 1.0
    t_max = np.full(N_RAYS, F32_MAX, np.float32)
    skip = rng.choice([-2, 0, 1], N_RAYS).astype(np.int32)
    cases = {}
    rand_rows = [r for r, _ in clusters]

    def lanes(b, lo, hi):
        return np.arange(b * BLOCK + lo, min(b * BLOCK + hi, N_RAYS))

    def aim_random(idx):
        """Lanes idx from near CENTRE at random clusters' real rows."""
        o[idx] = CENTRE + rng.uniform(-0.2, 0.2, (idx.size, 3))
        tt = rng.integers(0, N_CLUSTERS, idx.size)
        cen = np.stack([
            rand_rows[c][rng.choice(np.nonzero(rand_rows[c][:, 10] >= 0)[0]),
                         :9].reshape(3, 3).mean(0) for c in tt])
        d[idx] = _normalize(cen + rng.normal(0, 0.05, (idx.size, 3)) - o[idx])

    def row(b, lo, hi, x, y=0.0):
        """Lanes lo..hi-1 of block b at (x, y, 0) in the case's region."""
        idx = lanes(b, lo, hi)
        o[idx] = np.stack([x, np.full(idx.size, y), np.zeros(idx.size)],
                          1) + off[BLOCKS[b]]
        return idx

    for b in range(len(BLOCKS)):
        aim_random(lanes(b, 0, BLOCK))
    b = BLOCKS.index("axis_tie")
    cases["axis"] = row(b, 0, 1, np.array([0.5]), 0.1)  # the axis lane
    row(b, 1, 32, np.linspace(1.0, 3.0, 31))
    cases["tie"] = row(b, 32, 64, np.linspace(-1.5, -0.5, 32))
    d[lanes(b, 0, 64)] = (0.0, 0.0, 1.0)
    for name in ("window_take", "super_take"):
        b = BLOCKS.index(name)
        idx = lanes(b, 0, 512)
        o[idx] = rng.uniform(-0.3, 0.3, (512, 3)) * (1, 1, 0) + off[name]
        rel = o[idx] - off[name]
        d[idx] = _normalize(np.stack([0.02 * rel[:, 0], 0.02 * rel[:, 1],
                                      np.ones(512)], 1))
        cases[name] = idx
    b = BLOCKS.index("dead")
    idx = lanes(b, 0, 64)
    o[idx] = rng.uniform(-0.5, 0.5, (64, 3)) * (1, 1, 0) + off["dead"]
    d[idx] = (0.0, 0.0, 1.0)
    t_max[idx[:3]] = (0.0, -1.0, np.nan)
    t_max[idx[3:64:8]] = np.nan
    t_max[lanes(b, 64, 200)[::5]] = np.resize([0.0, -1.0], 28)
    cases["nan"] = idx[t_max[idx] != t_max[idx]]
    cases["dead"] = idx[:2]
    b = BLOCKS.index("skip")
    idx = lanes(b, 0, 64)
    o[idx] = rng.uniform(-0.5, 0.5, (64, 3)) * (1, 1, 0) + off["skip"]
    d[idx] = (0.0, 0.0, 1.0)
    skip[idx] = np.where(np.arange(64) % 2 == 0, 0, -2)
    cases["skip"] = idx
    b = BLOCKS.index("occ_vote")
    lane_a, lane_b = lanes(b, 0, 2)
    o[lane_a] = off["occ_vote"]
    d[lane_a] = _normalize([0.05, 0.0, 1.0])
    o[lane_b] = off["occ_vote"] + (-0.5, 0.3, 0.0)
    d[lane_b] = (0.0, 0.0, 1.0)
    cases["occ_vote"] = np.array([lane_a, lane_b])
    b = BLOCKS.index("padding")
    lane = lanes(b, 0, 1)[0]
    o[lane] = (0.3, 0.0, -10.0)
    d[lane] = (0.0, 0.0, 1.0)
    cases["padding"] = np.array([lane])

    dead = ~(t_max > 0.0)
    chord = np.where(dead, t_max, rng.uniform(1.0, 6.0, N_RAYS))
    chord[cases["skip"]] = 3.0
    chord[cases["occ_vote"]] = 5.0
    chord[cases["padding"]] = 20.0
    for name in ("window_take", "super_take"):
        chord[cases[name]] = 8.0
    dev = torch.device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    tl = SimpleNamespace(
        n_supers=len(supers), n_treelets=len(tboxes), leaf_size=k,
        super_bounds=f32(np.stack(sboxes)),
        super_range=torch.as_tensor(np.asarray(ranges, np.int32), device=dev),
        treelet_bounds=f32(np.stack(tboxes)),
        rows=f32(np.concatenate(rows)))
    return (tl, f32(o), f32(d), f32(t_max), f32(chord),
            torch.as_tensor(skip, device=dev), cases)


# --------------------------------------------------------------------
# The kernels' schedules, in plain PyTorch
# --------------------------------------------------------------------


def _windows(start, stop):
    for base in range(start, stop, WINDOW):
        yield base, range(base, min(base + WINDOW, stop))


def closest_schedule(tl, o, d, t_max, revote=("super", "treelet"), cut=0):
    """treelet_closest_kernel's schedule: (t, prim i32, b0, b1) over [N],
    as treelet_closest_plain returns them.  ``revote`` names the levels at
    which a lane that took a hit since the window's vote votes again at a
    box's turn (leaving one out is wrong); ``cut`` rows are left off the
    end of each walk (wrong unless 0)."""
    planes, n = ttt._pack(o, d, t_max)
    nb = planes[0].shape[0]
    k = tl.leaf_size
    rows = tl.rows.reshape(tl.n_treelets, k, -1)
    ranges = tl.super_range.tolist()
    out_t = planes[6].clone()
    out_p = torch.full_like(out_t, -1, dtype=torch.int32)
    out_b0, out_b1 = torch.zeros_like(out_t), torch.zeros_like(out_t)
    for b in range(nb):
        ln = _Block(planes, b)
        t, prim, b0, b1 = out_t[b], out_p[b], out_b0[b], out_b1[b]
        live = torch.nonzero(t > 0.0).squeeze(1)

        def turn(box, bits, took, level):
            if level not in revote:
                return bits
            return torch.where(took, ln.vote(box, t), bits)

        for _, sw in _windows(0, tl.n_supers):
            sbits = torch.stack([ln.vote(tl.super_bounds[s], t) for s in sw])
            took_s = torch.zeros(BLOCK, dtype=torch.bool)
            for js in torch.nonzero(sbits.any(dim=1)).squeeze(1).tolist():
                s = sw[js]
                if not bool(turn(tl.super_bounds[s], sbits[js], took_s,
                                 "super").any()):
                    continue
                t0, tc = ranges[s]
                for _, tw in _windows(t0, t0 + tc):
                    bits = torch.stack([ln.vote(tl.treelet_bounds[tt], t)
                                        for tt in tw])
                    took = torch.zeros(BLOCK, dtype=torch.bool)
                    for j in torch.nonzero(bits.any(dim=1)).squeeze(1).tolist():
                        tt = tw[j]
                        if not bool(turn(tl.treelet_bounds[tt], bits[j], took,
                                         "treelet").any()):
                            continue
                        tri = rows[tt]
                        last = _last_real(tri) - cut
                        ok, det, t_scaled, e0, e1 = ln.terms(tri[:last], live)
                        for r in range(last):
                            at = live
                            passed = ok[r] & _in_range(det[r], t_scaled[r],
                                                       t[at])
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
                    took_s |= took
    return tuple(x.reshape(-1)[:n] for x in (out_t, out_p, out_b0, out_b1))


def any_schedule(tl, o, d, t_max, skip, drop_occluded=False, cut=0):
    """treelet_any_kernel's schedule: occluded [N] bool.
    ``drop_occluded``: occluded lanes do not vote (wrong); ``cut`` rows are
    left off the end of each walk (wrong unless 0)."""
    planes, n = ttt._pack(o, d, t_max, skip)
    nb = planes[0].shape[0]
    k = tl.leaf_size
    rows = tl.rows.reshape(tl.n_treelets, k, -1)
    ranges = tl.super_range.tolist()
    occ_all = torch.zeros(nb, BLOCK, dtype=torch.bool)
    for b in range(nb):
        ln = _Block(planes, b)
        tm, sk = planes[6][b], planes[7][b].to(torch.float32)
        may = ~(tm <= 0.0) | ~ln.finite()
        occ = occ_all[b]

        def votes(boxes, w):
            bits = torch.stack([ln.vote(boxes[i], tm) for i in w])
            return bits & ~occ if drop_occluded else bits

        for _, sw in _windows(0, tl.n_supers):
            if not bool((may & ~occ).any()):
                break
            sbits = votes(tl.super_bounds, sw)
            for js in torch.nonzero(sbits.any(dim=1)).squeeze(1).tolist():
                t0, tc = ranges[sw[js]]
                for _, tw in _windows(t0, t0 + tc):
                    if not bool((may & ~occ).any()):
                        break
                    bits = votes(tl.treelet_bounds, tw)
                    for j in torch.nonzero(bits.any(dim=1)).squeeze(1).tolist():
                        at = torch.nonzero(may & ~occ).squeeze(1)
                        if at.numel() == 0:
                            break
                        tri = rows[tw[j]]
                        last = _last_real(tri) - cut
                        ok, det, t_scaled = ln.terms(tri[:last], at)[:3]
                        blocked = (ok & _in_range(det, t_scaled, tm[at])
                                   & (tri[:last, 9, None] != sk[at])
                                   & (tri[:last, 10, None] >= 0.0))
                        # The lane stops at its first blocker: the OR.
                        occ[at] |= blocked.any(dim=0)
    return occ_all.reshape(-1)[:n]


def _equal(got, ref):
    return all(torch.equal(g.view(torch.int32), r.view(torch.int32))
               for g, r in zip(got, ref))


@pytest.fixture(scope="module", params=[16, 64])
def built(request):
    return hand_built(request.param)


@pytest.fixture(scope="module")
def plain(built):
    tl, o, d, t_max, chord, skip, _ = built
    return (ttt.treelet_closest_plain(tl, o, d, t_max),
            ttt.treelet_any_plain(tl, o, d, chord, skip))


def test_closest_schedule_matches_plain(built, plain):
    tl, o, d, t_max, *_, cases = built
    ref = plain[0]
    assert _equal(closest_schedule(tl, o, d, t_max), ref)
    prim = ref[1]
    # The axis lane fails its own slab of the first treelet and takes its
    # triangle; the tie goes to the first super's treelet.
    assert int(prim[int(cases["axis"][0])]) == 40
    assert bool((prim[cases["tie"]] == 50).all())
    # A take closes a later treelet of the window, and a later super.
    assert bool((prim[cases["window_take"]] == 60).all())
    assert bool((prim[cases["super_take"]] == 62).all())
    # The ragged block: the axis lane takes the treelet only the padding
    # lanes vote for; dead lanes never take.
    assert int(prim[int(cases["padding"][0])]) == 100
    assert bool((prim[cases["nan"]] == -1).all())
    assert bool((prim[cases["dead"]] == -1).all())


def test_boxes_the_cases_rest_on(built):
    """The axis lanes' own slabs of the treelets they take fail (NaN); in
    the ragged block only padding lanes vote for the origin's treelet, and
    in occ_vote only lane A for the late super; the random block's lanes
    span the three frames; a super has more than a window of treelets and
    the supers fill more than one window."""
    tl, o, d, t_max, chord, _, cases = built
    ranges = tl.super_range.tolist()

    def own_slab(lane, box, t):
        inv = torch.reciprocal(d[lane])
        return bool(_slab(box[:6], *o[lane], *inv, t))

    ax = ranges[1][0]
    assert not own_slab(int(cases["axis"][0]), tl.treelet_bounds[ax],
                        t_max[int(cases["axis"][0])])
    pad = ranges[10][0]
    assert not own_slab(int(cases["padding"][0]), tl.treelet_bounds[pad],
                        chord[int(cases["padding"][0])])
    b = BLOCKS.index("padding")
    real = slice(b * BLOCK, N_RAYS)
    inv = torch.reciprocal(d[real])
    for box in (tl.treelet_bounds[pad], tl.super_bounds[10]):
        assert not bool(_slab(box[:6, None], *o[real].T, *inv.T,
                              chord[real]).any())
        assert bool(_slab(box[:6], 0.0, 0.0, 0.0, 1.0, 1.0, 1.0,
                          torch.tensor(0.0)))
    b = BLOCKS.index("occ_vote")
    lanes = slice(b * BLOCK, (b + 1) * BLOCK)
    inv = torch.reciprocal(d[lanes])
    late = ranges[9][0]
    for box in (tl.treelet_bounds[late], tl.super_bounds[9]):
        votes = _slab(box[:6, None], *o[lanes].T, *inv.T, chord[lanes])
        assert torch.nonzero(votes).reshape(-1).tolist() == [0]
    planes, _ = ttt._pack(o, d, t_max)
    frame = _Block(planes, BLOCKS.index("random")).frame
    assert set(frame.tolist()) == {0, 1, 2}
    assert ranges[0][1] > WINDOW and tl.n_supers > WINDOW


def test_any_schedule_matches_plain(built, plain):
    tl, o, d, _, chord, skip, cases = built
    ref = plain[1]
    assert torch.equal(any_schedule(tl, o, d, chord, skip), ref)
    # The NaN lanes are blocked, lanes at t_max 0 and -1 are not; the skip
    # id passes over the only occluder; B is blocked in the treelet only
    # the occluded A votes for; the padding case's axis lane is blocked.
    assert bool(ref[cases["nan"]].all())
    assert not bool(ref[cases["dead"]].any())
    sk = cases["skip"]
    assert not bool(ref[sk[0::2]].any()) and bool(ref[sk[1::2]].all())
    assert bool(ref[cases["occ_vote"]].all())
    assert bool(ref[int(cases["padding"][0])])


def test_vote_counts_and_block_order(built, plain):
    """treelet_votes_plain counts each block's treelets that some lane
    votes for at t_max inside the supers some lane votes for at t_max (the
    estimate by which the kernels launch their blocks, most votes first);
    the whole blocks in the order of the counts give the plain walks'
    bits, since a block's output depends on its own lanes alone."""
    tl, o, d, t_max, chord, skip, _ = built
    ranges = tl.super_range.tolist()
    for tm in (t_max, chord):
        planes, _ = ttt._pack(o, d, tm)
        votes = ttt.treelet_votes_plain(tl, o, d, tm)
        for b in range(planes[0].shape[0]):
            ln = _Block(planes, b)

            def some(box):
                return bool(ln.vote(box, planes[6][b]).any())
            want = sum(some(tl.treelet_bounds[tt])
                       for s, (t0, tc) in enumerate(ranges)
                       if some(tl.super_bounds[s])
                       for tt in range(t0, t0 + tc))
            assert int(votes[b]) == want
    full = N_RAYS // BLOCK  # the ragged block stays last
    order = torch.argsort(votes[:full], descending=True, stable=True)
    perm = torch.cat([(order[:, None] * BLOCK + torch.arange(BLOCK))
                      .reshape(-1), torch.arange(full * BLOCK, N_RAYS)])
    assert not torch.equal(order, torch.arange(full))
    got = ttt.treelet_closest_plain(tl, o[perm], d[perm], t_max[perm])
    for g, r in zip(got, plain[0]):
        back = torch.empty_like(g)
        back[perm] = g
        assert torch.equal(back.view(torch.int32), r.view(torch.int32))
    got = ttt.treelet_any_plain(tl, o[perm], d[perm], chord[perm], skip[perm])
    back = torch.empty_like(got)
    back[perm] = got
    assert torch.equal(back, plain[1])


@pytest.mark.parametrize("wrong", ["no super revote", "no treelet revote",
                                   "cut a row"])
def test_wrong_closest_schedules_differ(built, plain, wrong):
    tl, o, d, t_max, *_, cases = built
    if wrong == "cut a row":
        got = closest_schedule(tl, o, d, t_max, cut=1)
        assert int(got[1][int(cases["axis"][0])]) != 40
    else:
        level = wrong.split()[1]
        got = closest_schedule(tl, o, d, t_max,
                               revote=({"super", "treelet"} - {level}))
        case = "super_take" if level == "super" else "window_take"
        assert not bool((got[1][cases[case]] == plain[0][1][cases[case]])
                        .all())
    assert not _equal(got, plain[0])


@pytest.mark.parametrize("wrong", ["drop occluded", "cut a row"])
def test_wrong_any_schedules_differ(built, plain, wrong):
    tl, o, d, _, chord, skip, cases = built
    if wrong == "drop occluded":
        got = any_schedule(tl, o, d, chord, skip, drop_occluded=True)
        assert not bool(got[int(cases["occ_vote"][1])])
    else:
        got = any_schedule(tl, o, d, chord, skip, cut=1)
        assert not bool(got[cases["nan"]].any())
    assert not torch.equal(got, plain[1])
