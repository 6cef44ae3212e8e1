"""The bundle walker: port of ``yuki_tpu/ops/trace_walker.py``, the
divergent-wave engine behind ``traverse.WALKER_CLOSEST`` / ``WALKER_ANY``.

It replaces the slot stream's sort, fill, pack and merge.  A wave's rays
are cut into bundles of BUN = 8 consecutive rays; a bundle's candidate
list is the first C chunks of the OR of its rays' crossing words
(``trace_bundles.bundle_words``, ``trace_stream.extract_lists``), in
ascending chunk order.  The bundle walks its list once, testing its 8 rays
against each listed chunk's triangles, with a carry per (ray, triangle
slot) kept across the list; one fold per ray at the end picks the winner.

Kernels (a CUDA tensor launches the hand-written kernel in
``csrc/trace_walker.cu`` or raises; a CPU tensor runs the plain PyTorch
version beside it; each launch adds one to ``LAUNCHES``):

  walker_closest  replaces ``_walker_closest_kernel`` (trace_walker.py:204),
                  with ``skip`` its ``with_skip`` variant; plain:
                  ``walker_closest_plain``
  walker_any      replaces ``_walker_any_kernel`` (:269)
                  plain: ``walker_any_plain``

What changes a result, and is kept:

- The closest carry is one scaled hit (ts, det, prim) per ray and per
  triangle slot j of the walked chunks, seeded (t_max, 1, -1); a slot takes
  a new hit only on ts_c * det_b < ts_b * det_c, so the first in list order
  wins a tie within a slot.  The fold (``_lane_fold_closest``) halves the
  128 slots, slot i against slot i + h for h = 64 .. 1, taking the upper
  one when its cross-multiplied compare is smaller or equal with a lower
  prim id; misses enter as (F32_MAX, 1, BIG).  The scaled compare is not
  transitive, so neither the carry nor the pairing may be replaced by a
  running minimum.  t = ts / det by one IEEE divide.  With ``skip`` (the
  ray table's column 7) a slot never takes a triangle of the ray's skip
  light.
- Before each chunk, each ray's bound is the minimum over its 128 slots of
  ts / det, and a ray is live when t_max > 0 and its slab test of the
  chunk's box (``_bounds_recheck``: the finite reciprocal of
  ``_safe_inv``, max(tn, 0) <= min(tf, bound)) passes; a chunk no ray of
  the bundle is live for is skipped.  Occlusion: a ray is live while no
  slot has occluded it, against t_max; the verdict is the OR over slots.
- A bundle whose OR'd popcount exceeds C flags its 8 rays overflow.  The
  wave is budgeted in segments of ``_seg_b`` bundles, each bundle's pair
  count rounded up to QUAD (an empty list counts 1, so 4); ``ok`` is False
  when a segment's demand passes ``_mult_cap`` of its widest tier, and the
  caller falls back to the treelet walk.

What the TPU needed and the port does not copy: the plane-major triangle
table (``walker_tri_planes``), the (bundle, chunk) pair and quad tables
(``_bundle_pairs``), the per-segment sentinel blocks and the two tier
instantiations.
"""

from __future__ import annotations

import torch

from . import _build
from .trace import F32_MAX, ray_shear, watertight_scaled
from .trace_bundles import BUN, bundle_words
from .trace_rows import _tally
from .trace_stream import BIG, LANES, _safe_inv, extract_lists, host_int

QUAD = 4  # pairs per TPU grid step: each bundle's pair count rounds up to it
C_WALK = 64  # candidates per bundle
SEG_B = 2048  # bundles per pair-budget segment

LAUNCHES = {"walker_closest": 0, "walker_closest_skip": 0, "walker_any": 0}

_BATCH = 8192  # bundles per step of the plain walks (bounds their memory)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _seg_b(n_b: int) -> int:
    """Bundles per budget segment: SEG_B, or the whole wave when smaller."""
    return min(SEG_B, max(n_b, 1))


def _mult_cap(n_b: int, mult: int) -> int:
    """The pair budget of n_b bundles at ``mult`` pairs each."""
    return -(-(mult * n_b) // (2 * QUAD)) * 2 * QUAD


def budget_ok(lists, mult: int, mult_wide=None) -> torch.Tensor:
    """Whether every segment's pair demand fits its widest tier
    (trace_walker.py:430-445): a [] bool tensor."""
    n_b = lists.shape[0]
    seg_b = _seg_b(n_b)
    nseg = max(1, -(-n_b // seg_b))
    counts = (lists >= 0).sum(dim=1)
    aligned = -(-torch.clamp(counts, min=1) // QUAD) * QUAD
    # Pad bundles of the last segment have empty lists: one quad each.
    aligned = torch.cat([aligned, aligned.new_full((nseg * seg_b - n_b,),
                                                   QUAD)])
    demand = aligned.reshape(nseg, seg_b).sum(dim=1)
    top = mult_wide if mult_wide is not None and mult_wide > mult else mult
    return (demand <= _mult_cap(seg_b, top)).all()


# --------------------------------------------------------------------
# Plain versions of the two walks
# --------------------------------------------------------------------


def _bundle_planes(o, d, t_max, a: int, b: int):
    """Bundles [a, b) as [nb, 8] planes: ox, oy, oz, dx, dy, dz, t_max."""
    sl = slice(a * BUN, b * BUN)
    return [x[sl].reshape(b - a, BUN) for x in
            (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t_max)]


def _bounds_recheck(box, ox, oy, oz, dx, dy, dz, t_bound):
    """``_bounds_recheck``: each bundle's chunk box ``box`` [nb, 8] against
    its rays [nb, 8] and their bound, with the finite reciprocal."""
    mx, mn = torch.maximum, torch.minimum

    def axis(c, oc, dc):
        inv = _safe_inv(dc)
        return (box[:, c, None] - oc) * inv, (box[:, c + 3, None] - oc) * inv

    t0x, t1x = axis(0, ox, dx)
    t0y, t1y = axis(1, oy, dy)
    t0z, t1z = axis(2, oz, dz)
    tn = mx(mx(mn(t0x, t1x), mn(t0y, t1y)), mn(t0z, t1z))
    tf = mn(mn(mx(t0x, t1x), mx(t0y, t1y)), mx(t0z, t1z))
    return mx(tn, torch.zeros_like(tn)) <= mn(tf, t_bound)


def _chunk_cols(ch, tt):
    """The triangle rows of chunks tt [nb] as 12 columns [nb, 1, k]."""
    tri = ch.rows.reshape(-1, ch.leaf_size, ch.rows.shape[1])[tt]
    return [tri[:, None, :, c] for c in range(tri.shape[2])]


def _fold_closest(ts, det, prim, tm):
    """``_lane_fold_closest``: [nb, 8, 128] carries -> (t, prim i32)."""
    miss = prim < 0.0
    ts = torch.where(miss, F32_MAX, ts)
    det = torch.where(miss, 1.0, det)
    prim = torch.where(miss, BIG, prim)
    while ts.shape[2] > 1:
        h = ts.shape[2] // 2
        ts_a, ts_b = ts[..., :h], ts[..., h:]
        det_a, det_b = det[..., :h], det[..., h:]
        pr_a, pr_b = prim[..., :h], prim[..., h:]
        lhs = ts_b * det_a
        rhs = ts_a * det_b
        take_b = (lhs < rhs) | ((lhs == rhs) & (pr_b < pr_a))
        ts = torch.where(take_b, ts_b, ts_a)
        det = torch.where(take_b, det_b, det_a)
        prim = torch.where(take_b, pr_b, pr_a)
    hit = prim[..., 0] < BIG
    t = torch.where(hit, ts[..., 0] / det[..., 0], tm)
    return t, torch.where(hit, prim[..., 0], -1.0).to(torch.int32)


def walker_closest_plain(ch, lists, o, d, t_max, stats=None, skip=None):
    """Plain version of the closest walk (``_walker_closest_kernel`` and
    ``_lane_fold_closest``): lists [N / 8, C] i32 -> (t [N] f32, prim [N]
    i32), t = t_max and prim -1 on a miss; with ``skip`` [N] f32 a ray
    never takes a triangle of its skip light.  ``stats`` receives "boxes"
    (rechecks of rays with t_max > 0 of each listed chunk) and "tests"
    (live rays against the real triangles of each walked chunk)."""
    n = o.shape[0]
    n_b = n // BUN
    k = ch.leaf_size
    real = (ch.rows[:, 10] >= 0.0).reshape(-1, k).sum(dim=1)
    t_out = torch.empty_like(t_max)
    prim_out = torch.empty(n, dtype=torch.int32, device=o.device)
    for a in range(0, n_b, _BATCH):
        b = min(a + _BATCH, n_b)
        ox, oy, oz, dx, dy, dz, tm = _bundle_planes(o, d, t_max, a, b)
        sk = None if skip is None else skip[a * BUN:b * BUN].reshape(
            b - a, BUN)
        # Slots past the chunk width (k < 128) keep their seed, as the
        # TPU's padding lanes do.
        ts = tm[:, :, None].expand(b - a, BUN, LANES).clone()
        det = torch.ones_like(ts)
        prim = torch.full_like(ts, -1.0)
        for j in range(lists.shape[1]):
            tt = lists[a:b, j].to(torch.int64)
            on = tt >= 0
            if not bool(on.any()):
                break
            t_cur = (ts / det).amin(dim=2)
            live = (tm > 0.0) & _bounds_recheck(
                ch.treelet_bounds[tt.clamp(min=0)], ox, oy, oz, dx, dy, dz,
                t_cur)
            _tally(stats, "boxes", ((tm > 0.0) & on[:, None]).sum())
            r = torch.nonzero(on & live.any(dim=1)).squeeze(1)
            if r.numel() == 0:
                continue
            _tally(stats, "tests", (live[r].sum(dim=1) * real[tt[r]]).sum())
            cols = _chunk_cols(ch, tt[r])
            ray = [x[r][:, :, None] for x in (ox, oy, oz, dx, dy, dz)]
            ok, ts_c, det_c = watertight_scaled(ray_shear(*ray[3:]), *ray[:3],
                                                cols[:9])
            ts_b, det_b, prim_b = ts[r, :, :k], det[r, :, :k], prim[r, :, :k]
            closer = (ok & live[r][:, :, None] & (cols[10] >= 0.0)
                      & (ts_c * det_b < ts_b * det_c))
            if sk is not None:
                closer = closer & (cols[9] != sk[r][:, :, None])
            ts[r, :, :k] = torch.where(closer, ts_c, ts_b)
            det[r, :, :k] = torch.where(closer, det_c, det_b)
            prim[r, :, :k] = torch.where(closer, cols[10].expand_as(ts_c),
                                         prim_b)
        t, p = _fold_closest(ts, det, prim, tm)
        t_out[a * BUN:b * BUN] = t.reshape(-1)
        prim_out[a * BUN:b * BUN] = p.reshape(-1)
    return t_out, prim_out


def walker_any_plain(ch, lists, o, d, t_max, skip, stats=None):
    """Plain version of the occlusion walk (``_walker_any_kernel``): skip
    [N] f32 light ids -> [N] i32, 1 = occluded.  A ray is live for a chunk
    while unoccluded, with t_max > 0 and its box test against t_max; a
    triangle blocks it when it hits within t_max, is real and belongs to
    another light than ``skip``.  ``stats`` as for the closest walk."""
    n = o.shape[0]
    n_b = n // BUN
    k = ch.leaf_size
    real = (ch.rows[:, 10] >= 0.0).reshape(-1, k).sum(dim=1)
    occ_out = torch.empty(n, dtype=torch.int32, device=o.device)
    for a in range(0, n_b, _BATCH):
        b = min(a + _BATCH, n_b)
        ox, oy, oz, dx, dy, dz, tm = _bundle_planes(o, d, t_max, a, b)
        sk = skip[a * BUN:b * BUN].reshape(b - a, BUN)
        occ = torch.zeros((b - a, BUN, k), dtype=torch.bool, device=o.device)
        for j in range(lists.shape[1]):
            tt = lists[a:b, j].to(torch.int64)
            on = tt >= 0
            if not bool(on.any()):
                break
            live = (tm > 0.0) & ~occ.any(dim=2) & _bounds_recheck(
                ch.treelet_bounds[tt.clamp(min=0)], ox, oy, oz, dx, dy, dz, tm)
            _tally(stats, "boxes", ((tm > 0.0) & on[:, None]).sum())
            r = torch.nonzero(on & live.any(dim=1)).squeeze(1)
            if r.numel() == 0:
                continue
            _tally(stats, "tests", (live[r].sum(dim=1) * real[tt[r]]).sum())
            cols = _chunk_cols(ch, tt[r])
            ray = [x[r][:, :, None] for x in (ox, oy, oz, dx, dy, dz, tm, sk)]
            ok, ts_c, det_c = watertight_scaled(ray_shear(*ray[3:6]),
                                                *ray[:3], cols[:9])
            blocked = (ok & live[r][:, :, None] & (ts_c <= ray[6] * det_c)
                       & (cols[9] != ray[7]) & (cols[10] >= 0.0))
            occ[r] = occ[r] | blocked
        occ_out[a * BUN:b * BUN] = occ.any(dim=2).reshape(-1).to(torch.int32)
    return occ_out


# --------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------


def _check_walk(ch, lists, o, d, t_max, dev):
    n = o.shape[0]
    f32 = torch.float32
    if n % BUN:
        raise ValueError(f"{n} rays: the walker takes whole {BUN}-ray bundles")
    k = ch.leaf_size
    if not 1 <= k <= LANES:
        raise ValueError(f"leaf_size {k}: the walker takes at most {LANES}")
    _build.check(lists, "lists", torch.int32, (n // BUN, lists.shape[1]), dev)
    _build.check(ch.rows, "rows", f32, (ch.rows.shape[0], 12), dev)
    _build.check(ch.treelet_bounds, "treelet_bounds", f32,
                 (ch.n_treelets, 8), dev)
    _build.check(o, "o", f32, (n, 3), dev)
    _build.check(d, "d", f32, (n, 3), dev)
    _build.check(t_max, "t_max", f32, (n,), dev)
    return n


def walker_closest_walk(ch, lists, o, d, t_max, skip=None):
    """Closest hits of rays o, d [N,3], t_max [N] (N a multiple of 8) by
    the bundle walk over ``lists`` [N / 8, C] i32; with ``skip`` [N] f32,
    each ray ignores the triangles of its skip light.  Returns (t, prim
    i32)."""
    if not _build.dispatch(o):
        return walker_closest_plain(ch, lists, o, d, t_max, skip=skip)
    dev = o.device
    n = _check_walk(ch, lists, o, d, t_max, dev)
    if skip is not None:
        _build.check(skip, "skip", torch.float32, (n,), dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        name = "walker_closest" if skip is None else "walker_closest_skip"
        err = _build.library().yk_walker_closest(
            dev.index, _build.ptr(ch.treelet_bounds), _build.ptr(ch.rows),
            ch.leaf_size, _build.ptr(lists), lists.shape[1], n // BUN,
            _build.ptr(o), _build.ptr(d), _build.ptr(t_max),
            None if skip is None else _build.ptr(skip), _build.ptr(t),
            _build.ptr(prim), _build.stream(dev))
        _build.launch_check(err, name)
        LAUNCHES[name] += 1
    return t, prim


def walker_any_walk(ch, lists, o, d, t_max, skip):
    """Occlusion by the bundle walk; ``skip`` [N] f32 holds each ray's skip
    light id.  Returns [N] i32 (1 = occluded)."""
    if not _build.dispatch(o):
        return walker_any_plain(ch, lists, o, d, t_max, skip)
    dev = o.device
    n = _check_walk(ch, lists, o, d, t_max, dev)
    _build.check(skip, "skip", torch.float32, (n,), dev)
    occ = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        err = _build.library().yk_walker_any(
            dev.index, _build.ptr(ch.treelet_bounds), _build.ptr(ch.rows),
            ch.leaf_size, _build.ptr(lists), lists.shape[1], n // BUN,
            _build.ptr(o), _build.ptr(d), _build.ptr(t_max), _build.ptr(skip),
            _build.ptr(occ), _build.stream(dev))
        _build.launch_check(err, "walker_any")
        LAUNCHES["walker_any"] += 1
    return occ


# --------------------------------------------------------------------
# The walker's queries
# --------------------------------------------------------------------


def walker_lists(words, C: int):
    """(lists [N / 8, C] i32, overflow [N] bool) from per-ray crossing
    words [N, W]: the bundles' OR'd words, first C chunks each; a bundle
    past C flags its 8 rays."""
    lists, ov_b = extract_lists(bundle_words(words), C)
    return lists.contiguous(), ov_b.repeat_interleave(BUN)


def walker_closest_w(ch, words, o, d, t_max, C: int = C_WALK, mult: int = 16,
                     mult_wide=None, skip=None):
    """Closest hit over the bundle walker from per-ray crossing words
    [N, W] (``walker_closest_w``); ``skip`` [N] i32 (or None): each ray's
    light to ignore.  Returns (t, prim i32, overflow [N], ok): t = t_max
    and prim -1 on a miss; overflow rays may miss hits; when ok is False
    (a segment's pair demand passes its budget, one host read) the walk
    does not run and the caller falls back."""
    lists, overflow = walker_lists(words, C)
    if not host_int(budget_ok(lists, mult, mult_wide)):
        return (t_max.clone(), torch.full_like(t_max, -1, dtype=torch.int32),
                overflow, False)
    t, prim = walker_closest_walk(ch, lists, o, d, t_max, None if skip is None
                                  else skip.to(torch.float32).contiguous())
    return t, prim, overflow, True


def walker_any_w(ch, words, o, d, t_max, skip_light, C: int = C_WALK,
                 mult: int = 12, mult_wide=None):
    """Occlusion over the bundle walker (``walker_any_w``).  Returns
    (occluded [N] bool, overflow [N], ok); as walker_closest_w."""
    lists, overflow = walker_lists(words, C)
    if not host_int(budget_ok(lists, mult, mult_wide)):
        return (torch.zeros_like(t_max, dtype=torch.bool), overflow, False)
    occ = walker_any_walk(ch, lists, o, d, t_max,
                          skip_light.to(torch.float32).contiguous())
    return occ > 0, overflow, True
