"""Two-level treelet walk: port of ``yuki_tpu/ops/trace_treelets.py``.

Rays go in blocks of 1024 consecutive rays (the batch padded as
``_pack`` pads it, :196-210: origin 0, direction (1,1,1), t_max 0, skip
id -2).  A block walks the supers in order, then each visited super's
treelets, then each visited treelet's rows in order; it skips a super or
treelet box that no lane's slab test hits, each lane testing with its own
current t.  The closest walk carries (t, prim, b0, b1) and accepts a
triangle only when the watertight test hits it within the running t and
its t is strictly smaller; the occlusion walk ORs hits whose light id
differs from the lane's skip id (a float compare, so -2 skips nothing and
-1 skips every ordinary triangle) and leaves a block once all its lanes
are occluded.  Padding rows (prim id -1) never count.

  treelet_closest  replaces ``_closest_kernel`` (trace_treelets.py:55)
  treelet_any      replaces ``_any_kernel`` (:129)
  treelet_votes    replaces none: each block's treelet votes at t_max,
                   by which the closest walk launches its blocks, most first

A CUDA tensor launches the hand-written kernel in
``csrc/trace_treelets.cu`` (one thread per ray, one 1024-thread CUDA
block per ray block; boxes voted on 32 at a time, a visited treelet
staged as copies permuted for the block's shear frames and walked to its
last real row) or raises; a CPU tensor runs the plain PyTorch version
beside it, which makes the same visits and takes the same hits.  On the
card the closest walk first counts each block's votes
(``treelet_votes``) and launches its blocks most votes first; blocks are
independent, so the order moves no bit.  (The occlusion walk in that
order gained less than the count's own time, PERF.md §6.)  Each kernel
launch adds one to ``LAUNCHES``.

The plain closest walk tests a visited treelet's rows for all lanes of
the visiting blocks in one batch (everything that does not depend on the
running t), then runs the in-order accept (``_accept_in_order``): the
64-step sequential accept in a few rounds.
"""

from __future__ import annotations

import torch

from . import _build
from .trace import F32_MAX

BLOCK = 1024  # rays per block (yuki_tpu BLOCK_ROWS = 8 rows of 128)

LAUNCHES = {"treelet_closest": 0, "treelet_any": 0, "treelet_votes": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------


def _pack(o, d, t_max, skip=None):
    """[N] rays -> [nb, BLOCK] planes, padded like yuki_tpu's _pack."""
    n = o.shape[0]
    nb = max(-(-n // BLOCK), 1)
    pad = nb * BLOCK - n

    def plane(x, fill):
        if pad:
            x = torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                         device=x.device)])
        return x.reshape(nb, BLOCK)

    planes = [plane(o[:, k], 0.0) for k in range(3)]
    planes += [plane(d[:, k], 1.0) for k in range(3)]
    planes.append(plane(t_max, 0.0))
    if skip is not None:
        planes.append(plane(skip, -2))
    return planes, n


def _slab(box, ox, oy, oz, ix, iy, iz, t_cur):
    """Per-lane slab test of one box (lo 0-2, hi 3-5); NaN (0 * inf on
    an axis-parallel ray) propagates through min/max and fails the
    compare, as in jnp."""
    t0x = (box[0] - ox) * ix
    t1x = (box[3] - ox) * ix
    t0y = (box[1] - oy) * iy
    t1y = (box[4] - oy) * iy
    t0z = (box[2] - oz) * iz
    t1z = (box[5] - oz) * iz
    tmin = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
        torch.minimum(t0z, t1z),
    )
    tmax = torch.minimum(
        torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
        torch.maximum(t0z, t1z),
    )
    return torch.clamp(tmin, min=0.0) <= torch.minimum(tmax, t_cur)


class _Rays:
    """A ray batch as [nb, BLOCK] planes plus the per-ray parts of the
    watertight test (axis permutation, shear) and the slab inverses."""

    def __init__(self, ox, oy, oz, dx, dy, dz):
        self.o = (ox, oy, oz)
        self.inv = (torch.reciprocal(dx), torch.reciprocal(dy),
                    torch.reciprocal(dz))
        adx, ady, adz = torch.abs(dx), torch.abs(dy), torch.abs(dz)
        self.x_max = (adx > ady) & (adx > adz)
        self.y_max = (~self.x_max) & (ady > adz)
        ddx, ddy, ddz = self.permute(dx, dy, dz, self.x_max, self.y_max)
        self.inv_dz = torch.reciprocal(ddz)
        self.sx = -ddx * self.inv_dz
        self.sy = -ddy * self.inv_dz

    @staticmethod
    def permute(vx, vy, vz, x_max, y_max):
        px = torch.where(x_max, vy, torch.where(y_max, vz, vx))
        py = torch.where(x_max, vz, torch.where(y_max, vx, vy))
        pz = torch.where(x_max, vx, torch.where(y_max, vy, vz))
        return px, py, pz

    def slab(self, box, t_cur):
        return _slab(box, *self.o, *self.inv, t_cur)

    def lanes(self, vb, flat=True):
        """The per-lane terms of the blocks ``vb``, flattened, or [len(vb),
        BLOCK] with ``flat`` False."""
        def f(x):
            return x[vb].reshape(-1) if flat else x[vb]
        return dict(
            o=tuple(f(x) for x in self.o), x_max=f(self.x_max),
            y_max=f(self.y_max), sx=f(self.sx), sy=f(self.sy),
            inv_dz=f(self.inv_dz),
        )


def _edge_terms(ln, tri):
    """The t-independent part of the watertight test (ops/trace.py
    watertight, yuki_tpu ops/trace.py:120-173) for K rows ``tri`` [..., K,
    12] against M lanes (``ln``'s terms [..., M]): returns [..., K, M]
    (base_ok, det, t_scaled, inv_det, e0, e1), where base_ok = the sign and
    det tests pass."""
    def lanes(x):
        return x[..., None, :]

    ox, oy, oz = (lanes(x) for x in ln["o"])
    x_max, y_max = lanes(ln["x_max"]), lanes(ln["y_max"])
    sx, sy = lanes(ln["sx"]), lanes(ln["sy"])

    def corner(c):
        return _Rays.permute(tri[..., c, None] - ox,
                             tri[..., c + 1, None] - oy,
                             tri[..., c + 2, None] - oz, x_max, y_max)

    p0tx, p0ty, p0tz = corner(0)
    p1tx, p1ty, p1tz = corner(3)
    p2tx, p2ty, p2tz = corner(6)
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
        (e0 > 0) | (e1 > 0) | (e2 > 0)
    )
    det = e0 + e1 + e2
    miss_det = det == 0.0
    det_safe = torch.where(miss_det, torch.ones_like(det), det)
    t_scaled = (e0 * p0tz + e1 * p1tz + e2 * p2tz) * lanes(ln["inv_dz"])
    inv_det = torch.reciprocal(det_safe)
    return ~(miss_sign | miss_det), det, t_scaled, inv_det, e0, e1


def _in_range(det, t_scaled, t_cur):
    """The watertight test's range check against the running t."""
    neg = det < 0.0
    bound = t_cur * det
    miss = (neg & ((t_scaled >= 0.0) | (t_scaled < bound))) | (
        ~neg & ((t_scaled <= 0.0) | (t_scaled > bound))
    )
    return ~miss


def _accept_in_order(tri, terms, t_l, p_l, b0_l, b1_l):
    """The closest walk's in-order accept of K rows ``tri`` [..., K, 12]
    against lanes whose running (t, prim, b0, b1) are [..., M], given the
    rows' ``_edge_terms`` [..., K, M].  Each round finds, per lane, the
    first row from its position on that hits within its current t, is
    closer and is real (prim id >= 0), and takes it; rows passed over
    would have been rejected one by one too, because t changes only on an
    accept.  Returns the updated (t, prim, b0, b1)."""
    base_ok, det, t_scaled, inv_det, e0, e1 = terms
    k = tri.shape[-2]
    ti = t_scaled * inv_det
    cand = base_ok & (tri[..., 10] >= 0.0)[..., None]
    pid = tri[..., 10, None].expand_as(ti)
    row_k = torch.arange(k, device=ti.device)[:, None]
    pos = torch.zeros_like(p_l, dtype=torch.int64)
    while True:
        acc = (cand & (row_k >= pos[..., None, :])
               & _in_range(det, t_scaled, t_l[..., None, :])
               & (ti < t_l[..., None, :]))
        first = torch.where(acc, row_k, k).amin(dim=-2)
        took = first < k
        if not bool(took.any()):
            return t_l, p_l, b0_l, b1_l
        f = torch.clamp(first, max=k - 1)[..., None, :]

        def at(x):
            return x.gather(-2, f).squeeze(-2)

        t_l = torch.where(took, at(ti), t_l)
        p_l = torch.where(took, at(pid).to(torch.int32), p_l)
        b0_l = torch.where(took, at(e0 * inv_det), b0_l)
        b1_l = torch.where(took, at(e1 * inv_det), b1_l)
        pos = torch.where(took, first + 1, k)


def _visiting(mask):
    return torch.nonzero(mask).squeeze(1)


class _Tally:
    """The work a walk's query needs, counted per ray as a walk of one ray
    would do it: a ray tests a super box always, a treelet box only inside
    a super box its own slab test passes, and a treelet's real rows only
    when its own slab test of the treelet passes (the occlusion walk: up to
    the first occluding row, and nothing once occluded).  Padding lanes and
    padding rows count nothing.  So it is less than the block walk does,
    which tests every lane of a visiting block.  Counts are kept as
    tensors and read once, at the end, into ``stats`` ("boxes",
    "tests", and "treelets": how many treelets' rows some ray needs)."""

    def __init__(self, stats, tl, n, nb, device):
        self.stats = stats
        if stats is None:
            return
        self.valid = (torch.arange(nb * BLOCK, device=device) < n).reshape(
            nb, BLOCK)
        self.real_rows = (tl.rows[:, 10] >= 0.0).reshape(
            tl.n_treelets, tl.leaf_size).sum(dim=1)
        self.boxes = torch.zeros((), dtype=torch.int64, device=device)
        self.tests = torch.zeros((), dtype=torch.int64, device=device)
        self.needed = torch.zeros(tl.n_treelets, dtype=torch.bool,
                                  device=device)

    def add(self, boxes=None, tests=None, treelet=None) -> None:
        if boxes is not None:
            self.boxes += boxes.sum()
        if tests is not None:
            self.tests += tests.sum()
            self.needed[treelet] |= (tests > 0).any()

    def done(self) -> None:
        if self.stats is not None:
            for key, v in (("boxes", self.boxes), ("tests", self.tests),
                           ("treelets", self.needed.sum())):
                self.stats[key] = self.stats.get(key, 0) + int(v)


def treelet_closest_plain(tl, o, d, t_max, stats=None):
    """Plain version of the closest walk: (t, prim i32, b0, b1) over [N].
    ``stats`` (a dict or None) receives the box and triangle tests the
    query needs (``_Tally``)."""
    (ox, oy, oz, dx, dy, dz, tm), n = _pack(o, d, t_max)
    rays = _Rays(ox, oy, oz, dx, dy, dz)
    t = tm.clone()
    prim = torch.full_like(tm, -1, dtype=torch.int32)
    b0 = torch.zeros_like(tm)
    b1 = torch.zeros_like(tm)
    k = tl.leaf_size
    rows = tl.rows.reshape(tl.n_treelets, k, -1)
    ranges = tl.super_range.tolist()
    tally = _Tally(stats, tl, n, tm.shape[0], tm.device)
    for s in range(tl.n_supers):
        lane_s = rays.slab(tl.super_bounds[s], t)
        in_super = lane_s.any(dim=1)
        if stats is not None:
            lane_s = lane_s & tally.valid
            tally.add(boxes=tally.valid)
        if not bool(in_super.any()):
            continue
        t0, tc = ranges[s]
        for tt in range(t0, t0 + tc):
            lane_t = rays.slab(tl.treelet_bounds[tt], t)
            if stats is not None:
                tally.add(boxes=lane_s,
                          tests=(lane_s & lane_t) * tally.real_rows[tt],
                          treelet=tt)
            visit = in_super & lane_t.any(dim=1)
            vb = _visiting(visit)
            if vb.numel() == 0:
                continue
            tri = rows[tt]
            t_l, p_l, b0_l, b1_l = _accept_in_order(
                tri, _edge_terms(rays.lanes(vb), tri),
                *(x[vb].reshape(-1) for x in (t, prim, b0, b1)))
            nv = vb.numel()
            t[vb] = t_l.reshape(nv, BLOCK)
            prim[vb] = p_l.reshape(nv, BLOCK)
            b0[vb] = b0_l.reshape(nv, BLOCK)
            b1[vb] = b1_l.reshape(nv, BLOCK)
    tally.done()
    return (t.reshape(-1)[:n], prim.reshape(-1)[:n], b0.reshape(-1)[:n],
            b1.reshape(-1)[:n])


def treelet_any_plain(tl, o, d, t_max, skip_light, stats=None):
    """Plain version of the occlusion walk: occluded [N] bool.  ``stats``:
    as for treelet_closest_plain."""
    (ox, oy, oz, dx, dy, dz, tm, sk), n = _pack(o, d, t_max, skip_light)
    rays = _Rays(ox, oy, oz, dx, dy, dz)
    skip = sk.to(torch.float32)
    occ = torch.zeros_like(tm, dtype=torch.bool)
    k = tl.leaf_size
    rows = tl.rows.reshape(tl.n_treelets, k, -1)
    ranges = tl.super_range.tolist()
    tally = _Tally(stats, tl, n, tm.shape[0], tm.device)
    for s in range(tl.n_supers):
        live = (~occ).any(dim=1)
        lane_s = rays.slab(tl.super_bounds[s], tm)
        in_super = live & lane_s.any(dim=1)
        if stats is not None:
            tally.add(boxes=tally.valid & ~occ)
        if not bool(in_super.any()):
            continue
        t0, tc = ranges[s]
        for tt in range(t0, t0 + tc):
            live = in_super & (~occ).any(dim=1)
            lane_t = rays.slab(tl.treelet_bounds[tt], tm)
            visit = live & lane_t.any(dim=1)
            if stats is not None:
                need_box = tally.valid & ~occ & lane_s
                tally.add(boxes=need_box)
            vb = _visiting(visit)
            if vb.numel() == 0:
                continue
            tri = rows[tt]
            ln = rays.lanes(vb)
            base_ok, det, t_scaled, _, _, _ = _edge_terms(ln, tri)
            hit = base_ok & _in_range(det, t_scaled, tm[vb].reshape(-1)[None])
            blocked = (hit & (tri[:, 9, None] != skip[vb].reshape(-1)[None])
                       & (tri[:, 10, None] >= 0.0))
            if stats is not None:
                # Rows up to the first occluding one, else every real row.
                first = torch.where(blocked.any(dim=0),
                                    blocked.int().argmax(dim=0) + 1,
                                    tally.real_rows[tt])
                need = (need_box & lane_t)[vb].reshape(-1)
                tally.add(tests=first * need, treelet=tt)
            occ[vb] = occ[vb] | blocked.any(dim=0).reshape(vb.numel(), BLOCK)
    tally.done()
    return occ.reshape(-1)[:n]


def treelet_votes_plain(tl, o, d, t_max, stats=None):
    """Plain version of the vote count: [n_blocks] i32, each 1024-ray
    block's treelet votes at t_max (treelets some lane's slab passes at
    its t_max) inside the supers it votes for at t_max.  ``stats`` (a dict
    or None) receives "boxes", the lane box tests the count makes."""
    (ox, oy, oz, dx, dy, dz, tm), _ = _pack(o, d, t_max)
    rays = _Rays(ox, oy, oz, dx, dy, dz)
    votes = torch.zeros(tm.shape[0], dtype=torch.int32, device=tm.device)
    boxes = tl.n_supers * tm.shape[0]
    for s, (t0, tc) in enumerate(tl.super_range.tolist()):
        in_super = rays.slab(tl.super_bounds[s], tm).any(dim=1)
        boxes += int(in_super.sum()) * tc
        for tt in range(t0, t0 + tc) if bool(in_super.any()) else ():
            votes += in_super & rays.slab(tl.treelet_bounds[tt],
                                          tm).any(dim=1)
    if stats is not None:
        stats["boxes"] = stats.get("boxes", 0) + boxes * BLOCK
    return votes


# --------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------


def _check_rays(tl, o, d, t_max, dev):
    n = o.shape[0]
    f32 = torch.float32
    _build.check(o, "o", f32, (n, 3), dev)
    _build.check(d, "d", f32, (n, 3), dev)
    _build.check(t_max, "t_max", f32, (n,), dev)
    k = tl.leaf_size
    _build.check(tl.super_bounds, "super_bounds", f32, (tl.n_supers, 8), dev)
    _build.check(tl.super_range, "super_range", torch.int32, (tl.n_supers, 2), dev)
    _build.check(tl.treelet_bounds, "treelet_bounds", f32, (tl.n_treelets, 8), dev)
    _build.check(tl.rows, "rows", f32, (tl.n_treelets * k, 12), dev)
    for t, name in ((tl.super_bounds, "super_bounds"),
                    (tl.treelet_bounds, "treelet_bounds"), (tl.rows, "rows")):
        _build.check_aligned(t, name)
    if not 1 <= k <= 256:
        raise ValueError(f"leaf_size {k} outside [1, 256]")
    return n


def treelet_votes(tl, o, d, t_max):
    """Each 1024-ray block's treelet votes at t_max inside the supers it
    votes for at t_max: [n_blocks] i32 (``treelet_votes_plain``)."""
    if not _build.dispatch(o):
        return treelet_votes_plain(tl, o, d, t_max)
    dev = o.device
    n = _check_rays(tl, o, d, t_max, dev)
    votes = torch.empty(max(-(-n // BLOCK), 1), dtype=torch.int32, device=dev)
    err = _build.library().yk_treelet_votes(
        dev.index, _build.ptr(tl.super_bounds), _build.ptr(tl.super_range),
        _build.ptr(tl.treelet_bounds), tl.n_supers, _build.ptr(o),
        _build.ptr(d), _build.ptr(t_max), n, _build.ptr(votes),
        _build.stream(dev),
    )
    _build.launch_check(err, "treelet_votes")
    _build.bump(LAUNCHES, "treelet_votes")
    return votes


def _block_order(tl, o, d, t_max):
    """The closest walk's launch order: the ray blocks, most votes
    first."""
    votes = treelet_votes(tl, o, d, t_max)
    return torch.argsort(votes, descending=True, stable=True).to(torch.int32)


def treelet_closest(tl, o, d, t_max):
    """Closest hit by the two-level treelet walk.  o, d [N,3], t_max [N]
    -> (t, prim i32, b0, b1) over [N]; prim -1 and t = t_max on a miss."""
    if not _build.dispatch(o):
        return treelet_closest_plain(tl, o, d, t_max)
    dev = o.device
    n = _check_rays(tl, o, d, t_max, dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    b0 = torch.empty_like(t)
    b1 = torch.empty_like(t)
    if n == 0:
        return t, prim, b0, b1
    order = _block_order(tl, o, d, t_max)
    err = _build.library().yk_treelet_closest(
        dev.index, _build.ptr(tl.super_bounds), _build.ptr(tl.super_range),
        _build.ptr(tl.treelet_bounds), _build.ptr(tl.rows), tl.n_supers, tl.leaf_size,
        _build.ptr(order), _build.ptr(o), _build.ptr(d), _build.ptr(t_max), n,
        _build.ptr(t), _build.ptr(prim), _build.ptr(b0), _build.ptr(b1), _build.stream(dev),
    )
    _build.launch_check(err, "treelet_closest")
    _build.bump(LAUNCHES, "treelet_closest")
    return t, prim, b0, b1


def treelet_any(tl, o, d, t_max, skip_light):
    """Occlusion by the two-level treelet walk.  skip_light [N] i32: the
    area-light id whose triangles the lane ignores (-2: none).  Returns
    occluded [N] bool."""
    if not _build.dispatch(o):
        return treelet_any_plain(tl, o, d, t_max, skip_light)
    dev = o.device
    n = _check_rays(tl, o, d, t_max, dev)
    _build.check(skip_light, "skip_light", torch.int32, (n,), dev)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    err = _build.library().yk_treelet_any(
        dev.index, _build.ptr(tl.super_bounds), _build.ptr(tl.super_range),
        _build.ptr(tl.treelet_bounds), _build.ptr(tl.rows), tl.n_supers, tl.leaf_size,
        _build.ptr(o), _build.ptr(d), _build.ptr(t_max), _build.ptr(skip_light), n,
        _build.ptr(occ), _build.stream(dev),
    )
    _build.launch_check(err, "treelet_any")
    _build.bump(LAUNCHES, "treelet_any")
    return occ
