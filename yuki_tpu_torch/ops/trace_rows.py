"""Row-union traversal, the treelet dispatch's engine for coherent waves:
port of ``yuki_tpu/ops/trace_rows.py``.

The 128 rays of a film-order row cross few chunks in union, so each row
walks one candidate list, the chunks its union words name, with its rays
in natural order and each ray's running result carried across the list.
Per chunk, a recheck of the chunk's box against each lane's running best
decides for the whole row: the chunk is walked by all 128 lanes as soon
as one lane's recheck passes.

``row_words_interval`` is the dispatch's probe: conservative union words
per row.  ``rows_closest_w`` / ``rows_any_w`` walk them; rays of a row
whose list was cut at C, or of a segment whose pair demand blew the pair
budget, are flagged overflow and re-run by the caller.  The exact union
words (``row_words_of`` over ``trace_stream.cross_words``) feed
``row_candidate_lists`` and the stand-alone queries ``rows_closest`` /
``rows_any`` (trace_rows.py:39-56, :428-477), which nothing on a frame
path calls.

Kernels (a CUDA tensor launches the hand-written kernel in
``csrc/trace_rows.cu`` or raises; a CPU tensor runs the plain PyTorch
version beside it; each launch adds one to ``LAUNCHES``):

  rows_closest_walk  replaces ``_rows_closest_kernel`` (trace_rows.py:246),
                     with ``skip`` its ``with_skip`` variant
  rows_any_walk      replaces ``_rows_any_kernel`` (:299)

What the TPU needed and the port does not copy: the (row, chunk) pair
table, its QUAD grouping and the dead row block exist to feed a
sequential grid from prefetched scalars, and the SEG_R segments to fit
that table in SMEM.  The decisions they make that change a result are
kept: which pairs a segment's budget drops (``kept_lists``) and which
rays are flagged for it.
"""

from __future__ import annotations

import torch

from ..profiling import pass_scope
from . import _build
from .trace import ray_shear, scaled_min8, watertight_scaled
from .trace_stream import LANES, cross_words, extract_lists, n_words, pack_bits

C_ROW = 64  # union candidates per 128-ray row of the stand-alone queries
QUAD = 4  # pairs per TPU grid step: each row's pair count rounds up to it
SEG_R = 2048  # rows per pair-budget segment

LAUNCHES = {"rows_closest": 0, "rows_closest_skip": 0, "rows_any": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def axis_interval(lo_a, hi_a, olo, ohi, dlo, dhi):
    """Conservative [t_enter, t_exit] of one axis for a bundle of rays
    with origins in [olo, ohi] and directions in [dlo, dhi] against boxes
    [lo_a, hi_a] (trace_rows.py:94-108, trace_pairs.py:86-101): a
    direction interval that spans zero gives [0, inf)."""
    pos = dlo > 0.0
    neg = dhi < 0.0
    n_lo = lo_a - ohi
    t_en_pos = n_lo / torch.where(n_lo >= 0.0, dhi, dlo)
    m_hi = hi_a - olo
    t_ex_pos = m_hi / torch.where(m_hi >= 0.0, dlo, dhi)
    n_hi = hi_a - olo
    t_en_neg = n_hi / torch.where(n_hi <= 0.0, dlo, dhi)
    m_lo = lo_a - ohi
    t_ex_neg = m_lo / torch.where(m_lo <= 0.0, dhi, dlo)
    t_en = torch.where(pos, t_en_pos, torch.where(neg, t_en_neg, 0.0))
    t_ex = torch.where(pos, t_ex_pos,
                       torch.where(neg, t_ex_neg, float("inf")))
    return t_en, t_ex


def row_words_of(words, rows: int):
    """Per-ray crossing words [N, W] -> per-row union words [rows, W]: the
    OR over each row's 128 rays (``row_words_of``)."""
    grouped = words.reshape(rows, LANES, words.shape[1])
    out = grouped[:, 0].clone()
    for r in range(1, LANES):
        out |= grouped[:, r]
    return out


def row_candidate_lists(ch, o, d, t_max, C: int):
    """Per-row union lists of the chunks each 128-ray row's rays cross
    exactly: (lists [rows, C] i32 (-1 pad), row overflow [rows] bool)."""
    words = cross_words(ch, o, d, t_max)
    return extract_lists(row_words_of(words, o.shape[0] // LANES), C)


def row_words_interval(ch, o, d, t_max, group: int = LANES):
    """Conservative crossing words [rows, W] (u32 in int64) of each group
    of ``group`` rays, by interval arithmetic over the group's origin box,
    per-axis direction interval and largest t: a direction interval that
    spans zero constrains nothing on its axis.  A superset of the union of
    the group's exact crossings; pad chunks are masked by id."""
    n = o.shape[0]
    rows = n // group
    n_c = ch.n_treelets
    w = n_words(n_c)
    ch_pad = w * 32
    dev = o.device

    ob = o.reshape(rows, group, 3)
    db = d.reshape(rows, group, 3)
    o_lo = ob.amin(dim=1)[:, None, :]  # [rows, 1, 3]
    o_hi = ob.amax(dim=1)[:, None, :]
    d_lo = db.amin(dim=1)[:, None, :]
    d_hi = db.amax(dim=1)[:, None, :]
    t_hi = t_max.reshape(rows, group).amax(dim=1)  # [rows]

    cb = ch.treelet_bounds
    inf = torch.full((ch_pad - n_c, 3), float("inf"), device=dev)
    lo_t = torch.cat([cb[:, 0:3], inf])[None]  # [1, ch_pad, 3]
    hi_t = torch.cat([cb[:, 3:6], inf])[None]

    t_en = torch.zeros((rows, 1), device=dev)
    t_ex = t_hi[:, None].expand(rows, ch_pad)
    for a in range(3):
        en, ex = axis_interval(lo_t[..., a], hi_t[..., a], o_lo[..., a],
                               o_hi[..., a], d_lo[..., a], d_hi[..., a])
        en = torch.where(torch.isnan(en), 0.0, en)
        ex = torch.where(torch.isnan(ex), float("inf"), ex)
        t_en = torch.maximum(t_en, en)
        t_ex = torch.minimum(t_ex, ex)
    crossed = (torch.clamp(t_en, min=0.0) <= t_ex) & (t_hi > 0.0)[:, None]
    crossed = crossed & (torch.arange(ch_pad, device=dev) < n_c)
    return pack_bits(crossed)


def kept_lists(row_words, C: int, mult: int):
    """The lists the rows engine walks, from union words [rows, W]:
    (lists [rows, C] i32, ascending chunk ids, -1 past the end; overflow
    [rows] bool).

    As ``rows_closest_w`` (:389-397) and ``_row_pairs`` (:187-220): a row
    with an empty list walks chunk 0 (its forced pair); a row whose union
    exceeds C overflows.  Rows are budgeted in segments of
    seg_r = min(SEG_R, rows): each row's count rounds up to QUAD, the
    segment's rows take pair slots in order, and a pair past the
    segment's cap = ceil(mult * seg_r / 8) * 8 is dropped; a segment that
    drops any pair flags all its rows."""
    rows = row_words.shape[0]
    dev = row_words.device
    lists, overflow = extract_lists(row_words, C)
    lists[:, 0] = torch.clamp(lists[:, 0], min=0)
    seg_r = min(SEG_R, max(rows, 1))
    nseg = max(1, -(-rows // seg_r))
    cap = -(-(mult * seg_r) // (2 * QUAD)) * 2 * QUAD
    aligned = -(-(lists >= 0).sum(dim=1) // QUAD) * QUAD
    aligned = torch.cat([aligned, aligned.new_zeros(nseg * seg_r - rows)])
    aligned = aligned.reshape(nseg, seg_r)
    off = (torch.cumsum(aligned, dim=1) - aligned).reshape(-1)[:rows]
    seg_ov = (aligned.sum(dim=1) > cap).repeat_interleave(seg_r)[:rows]
    keep = torch.clamp(cap - off, min=0)
    kept = torch.arange(C, device=dev) < keep[:, None]
    lists = torch.where(kept, lists, -1)
    return lists.to(torch.int32).contiguous(), overflow | seg_ov


# --------------------------------------------------------------------
# Row walks (kernel 9) and their plain versions
# --------------------------------------------------------------------


def _row_planes(o, d, t_max):
    """The rays as [rows, 128] planes: ox, oy, oz, dx, dy, dz, t."""
    rows = o.shape[0] // LANES
    return [x.reshape(rows, LANES) for x in
            (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t_max)]


def _recheck(cb, ox, oy, oz, dx, dy, dz, ts_cur, det_cur):
    """``_recheck``: each row's chunk box ``cb`` [R, 8] against its lanes
    [R, 128] and their running best t = ts / det, cross-multiplied.  The
    reciprocal is a plain 1 / d and min/max propagate NaN, so an
    axis-parallel ray's 0 * inf fails the test, as on the TPU."""
    def axis(lo, hi, oc, dc):
        inv = torch.reciprocal(dc)
        return (lo[:, None] - oc) * inv, (hi[:, None] - oc) * inv

    t0x, t1x = axis(cb[:, 0], cb[:, 3], ox, dx)
    t0y, t1y = axis(cb[:, 1], cb[:, 4], oy, dy)
    t0z, t1z = axis(cb[:, 2], cb[:, 5], oz, dz)
    mx, mn = torch.maximum, torch.minimum
    tmin = mx(mx(mn(t0x, t1x), mn(t0y, t1y)), mn(t0z, t1z))
    tmax_box = mn(mn(mx(t0x, t1x), mx(t0y, t1y)), mx(t0z, t1z))
    tmin = mx(tmin, torch.zeros_like(tmin))
    return (tmin <= tmax_box) & (tmin * det_cur <= ts_cur)


def _chunk_groups(ch, tt):
    """Each row's chunk tt [R] as [R, k // 8, 8, 12] triangle rows."""
    groups = ch.rows.reshape(-1, ch.leaf_size // 8, 8, ch.rows.shape[1])
    return groups[tt.to(torch.int64)]


def _group_cols(blk):
    """One group of 8 triangle rows [R, 8, 12] as columns [8, R, 1]."""
    return [blk[:, :, c].T[:, :, None] for c in range(12)]


def _tally(stats, key, value) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(value)


def rows_closest_walk_plain(ch, lists, o, d, t_max, stats=None, skip=None):
    """Plain version of the closest row walk (``_rows_closest_kernel``):
    [3, N] f32 rows (scaled ts, prim, det).  Each row starts at (t_max, -1,
    1) per lane and walks its list in order; a chunk is walked by all the
    row's lanes when some lane with t_max > 0 passes its recheck, with the
    eight carries of closest_walk seeded from the running best.  With
    ``skip`` [N] f32 (plane 7 of the ``with_skip`` variant) a triangle
    whose light id equals the lane's is never taken.  ``stats`` receives
    "boxes" (rechecks of lanes with t_max > 0) and "tests" (such lanes
    against the real triangles of each walked chunk)."""
    ox, oy, oz, dx, dy, dz, tm = _row_planes(o, d, t_max)
    sk = None if skip is None else skip.reshape(tm.shape)
    pre = ray_shear(dx, dy, dz)
    live = tm > 0.0
    ts, det = tm.clone(), torch.ones_like(tm)
    prim = torch.full_like(tm, -1.0)
    real = (ch.rows[:, 10] >= 0.0).reshape(-1, ch.leaf_size).sum(dim=1)
    for j in range(lists.shape[1]):
        tt = lists[:, j].to(torch.int64)
        on = tt >= 0
        if not bool(on.any()):
            break
        cb = ch.treelet_bounds[tt.clamp(min=0)]
        near = live & _recheck(cb, ox, oy, oz, dx, dy, dz, ts, det)
        _tally(stats, "boxes", (live & on[:, None]).sum())
        r = torch.nonzero(on & near.any(dim=1)).squeeze(1)
        if r.numel() == 0:
            continue
        _tally(stats, "tests", (live[r].sum(dim=1) * real[tt[r]]).sum())
        lane = [x[r] for x in (ox, oy, oz)]
        pre_r = tuple(x[r] for x in pre)
        ts_b = ts[r].expand(8, -1, -1)
        det_b = det[r].expand(8, -1, -1)
        prim_b = prim[r].expand(8, -1, -1)
        groups = _chunk_groups(ch, tt[r])
        for g in range(groups.shape[1]):
            cols = _group_cols(groups[:, g])
            ok, ts_c, det_c = watertight_scaled(pre_r, *lane, cols[:9])
            pid = cols[10]
            closer = ok & (pid >= 0.0) & (ts_c * det_b < ts_b * det_c)
            if sk is not None:
                closer = closer & (cols[9] != sk[r])
            ts_b = torch.where(closer, ts_c, ts_b)
            det_b = torch.where(closer, det_c, det_b)
            prim_b = torch.where(closer, pid, prim_b)
        ts[r], det[r], prim[r] = scaled_min8(ts_b, det_b, prim_b)
    return torch.stack([ts.reshape(-1), prim.reshape(-1), det.reshape(-1)])


def rows_any_walk_plain(ch, lists, o, d, t_max, skip, stats=None):
    """Plain version of the occlusion row walk (``_rows_any_kernel``):
    [N] i32, 1 = occluded.  A lane crosses a chunk when t_max > 0 and its
    recheck against t_max passes; the row enters the chunk when a
    crossing lane is unoccluded, ORs each group of 8 triangles' hits
    (light id other than the lane's ``skip`` [N] f32) into every lane, and
    leaves it after the first group at which no crossing lane is
    unoccluded (``any_walk``).  ``stats``: "boxes" as for the closest walk,
    "tests" the lanes with t_max > 0 against the real triangles of the
    groups walked."""
    ox, oy, oz, dx, dy, dz, tm = _row_planes(o, d, t_max)
    sk = skip.reshape(tm.shape)
    pre = ray_shear(dx, dy, dz)
    live = tm > 0.0
    ones = torch.ones_like(tm)
    occ = torch.zeros_like(tm, dtype=torch.bool)
    for j in range(lists.shape[1]):
        tt = lists[:, j].to(torch.int64)
        on = tt >= 0
        if not bool(on.any()):
            break
        cb = ch.treelet_bounds[tt.clamp(min=0)]
        crossing = live & _recheck(cb, ox, oy, oz, dx, dy, dz, tm, ones)
        _tally(stats, "boxes", (live & on[:, None]).sum())
        r = torch.nonzero(on & (crossing & ~occ).any(dim=1)).squeeze(1)
        if r.numel() == 0:
            continue
        lane = [x[r] for x in (ox, oy, oz)]
        pre_r = tuple(x[r] for x in pre)
        tm_r, sk_r, cross_r, occ_r = tm[r], sk[r], crossing[r], occ[r]
        n_live = live[r].sum(dim=1)
        going = torch.ones(r.shape[0], dtype=torch.bool, device=o.device)
        groups = _chunk_groups(ch, tt[r])
        for g in range(groups.shape[1]):
            cols = _group_cols(groups[:, g])
            ok, ts_c, det_c = watertight_scaled(pre_r, *lane, cols[:9])
            blocked = (ok & (ts_c <= tm_r * det_c) & (cols[9] != sk_r)
                       & (cols[10] >= 0.0)).any(dim=0)
            occ_r = occ_r | (blocked & going[:, None])
            _tally(stats, "tests", (n_live * (cols[10][:, :, 0] >= 0.0).sum(
                dim=0) * going).sum())
            going = going & (cross_r & ~occ_r).any(dim=1)
            if not bool(going.any()):
                break
        occ[r] = occ_r
    return occ.reshape(-1).to(torch.int32)


def _check_rows(ch, lists, o, d, t_max, dev):
    n = o.shape[0]
    f32 = torch.float32
    if n % LANES:
        raise ValueError(f"{n} rays: the row walks take whole 128-ray rows")
    k = ch.leaf_size
    if k % 8 or not 8 <= k <= 256:
        raise ValueError(f"leaf_size {k}: a multiple of 8 in [8, 256]")
    _build.check(lists, "lists", torch.int32, (n // LANES, lists.shape[1]),
                 dev)
    _build.check(ch.rows, "rows", f32, (ch.rows.shape[0], 12), dev)
    _build.check(ch.treelet_bounds, "treelet_bounds", f32,
                 (ch.n_treelets, 8), dev)
    _build.check(o, "o", f32, (n, 3), dev)
    _build.check(d, "d", f32, (n, 3), dev)
    _build.check(t_max, "t_max", f32, (n,), dev)
    _build.check_aligned(ch.rows, "rows")
    return n


def rows_closest_walk(ch, lists, o, d, t_max, skip=None):
    """Closest row walk of rays o, d [N,3], t_max [N] (N a multiple of 128)
    over each row's list in ``lists`` [N / 128, C] (``kept_lists``); with
    ``skip`` [N] f32, each lane ignores the triangles of its skip light.
    Returns [3, N] f32: scaled ts, prim id, det."""
    if not _build.dispatch(o):
        return rows_closest_walk_plain(ch, lists, o, d, t_max, skip=skip)
    dev = o.device
    n = _check_rows(ch, lists, o, d, t_max, dev)
    if skip is not None:
        _build.check(skip, "skip", torch.float32, (n,), dev)
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    if n:
        name = "rows_closest" if skip is None else "rows_closest_skip"
        err = _build.library().yk_rows_closest(
            dev.index, _build.ptr(ch.treelet_bounds), _build.ptr(ch.rows),
            ch.leaf_size, _build.ptr(lists), lists.shape[1], n // LANES,
            _build.ptr(o), _build.ptr(d), _build.ptr(t_max),
            None if skip is None else _build.ptr(skip), _build.ptr(out),
            _build.stream(dev))
        _build.launch_check(err, name)
        _build.bump(LAUNCHES, name)
    return out


def rows_any_walk(ch, lists, o, d, t_max, skip):
    """Occlusion row walk; ``skip`` [N] f32 holds each ray's skip light id.
    Returns [N] i32 (1 = occluded)."""
    if not _build.dispatch(o):
        return rows_any_walk_plain(ch, lists, o, d, t_max, skip)
    dev = o.device
    n = _check_rows(ch, lists, o, d, t_max, dev)
    _build.check(skip, "skip", torch.float32, (n,), dev)
    occ = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        err = _build.library().yk_rows_any(
            dev.index, _build.ptr(ch.treelet_bounds), _build.ptr(ch.rows),
            ch.leaf_size, _build.ptr(lists), lists.shape[1], n // LANES,
            _build.ptr(o), _build.ptr(d), _build.ptr(t_max), _build.ptr(skip),
            _build.ptr(occ), _build.stream(dev))
        _build.launch_check(err, "rows_any")
        _build.bump(LAUNCHES, "rows_any")
    return occ


# --------------------------------------------------------------------
# The rows engine's queries
# --------------------------------------------------------------------


def rows_closest_w(ch, row_words, o, d, t_max, *, C: int, mult: int,
                   skip=None):
    """Closest hit by the row-union walk from per-row union words
    (``rows_closest_w``); ``skip`` [N] i32 (or None): each lane's light to
    ignore.  Returns (t, prim i32, overflow [N]): t = t_max and prim -1 on
    a miss, t = ts / det by one divide per ray; overflow rays may miss
    hits and are re-run by the caller."""
    with pass_scope("traverse.layout"):
        lists, overflow = kept_lists(row_words, C, mult)
    with pass_scope("traverse.walk"):
        out = rows_closest_walk(ch, lists, o, d, t_max, None if skip is None
                                else skip.to(torch.float32).contiguous())
    prim = out[1]
    t = torch.where(prim >= 0.0, out[0] / out[2], t_max)
    return t, prim.to(torch.int32), overflow.repeat_interleave(LANES)


def rows_any_w(ch, row_words, o, d, t_max, skip_light, *, C: int,
               mult: int):
    """Occlusion by the row-union walk (``rows_any_w``).  Returns
    (occluded [N] bool, overflow [N]); an overflow ray may be falsely
    unoccluded."""
    with pass_scope("traverse.layout"):
        lists, overflow = kept_lists(row_words, C, mult)
    with pass_scope("traverse.walk"):
        occ = rows_any_walk(ch, lists, o, d, t_max,
                            skip_light.to(torch.float32).contiguous())
    return occ > 0, overflow.repeat_interleave(LANES)


def rows_closest(ch, o, d, t_max, C: int = C_ROW, mult: int = 16):
    """Stand-alone row-union closest hit (``rows_closest``): the exact
    crossing words' row unions, then ``rows_closest_w``."""
    rw = row_words_of(cross_words(ch, o, d, t_max), o.shape[0] // LANES)
    return rows_closest_w(ch, rw, o, d, t_max, C=C, mult=mult)


def rows_any(ch, o, d, t_max, skip_light, C: int = C_ROW, mult: int = 16):
    """Stand-alone row-union occlusion (``rows_any``)."""
    rw = row_words_of(cross_words(ch, o, d, t_max), o.shape[0] // LANES)
    return rows_any_w(ch, rw, o, d, t_max, skip_light, C=C, mult=mult)
