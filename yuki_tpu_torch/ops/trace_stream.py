"""Exact per-ray incidence stream: port of ``yuki_tpu/ops/trace_stream.py``,
the divergent-wave engine of the treelet dispatch.

A wave's rays get exact per-ray lists of the ~128-triangle chunks they
cross (``ops/trace_cull.py``, or ``cross_words`` + ``extract_lists``);
the (ray, chunk) candidates are sorted chunk-major into 128-slot rows;
each slot row walks its chunk's triangles against its 128 gathered rays;
a per-ray merge keeps each ray's closest hit (or ORs its occlusion).
Rays whose list was cut at C are flagged overflow; the caller re-runs
them through the wide pass (``stream_closest`` / ``stream_any`` at
C_WIDE), and a wave whose slot demand blows its budget falls back to the
treelet walk (``traverse``).

Kernels (a CUDA tensor launches the hand-written kernel in
``csrc/trace_stream.cu`` or raises; a CPU tensor runs the plain PyTorch
version beside it; each launch adds one to ``LAUNCHES``):

  cross_words   replaces ``_cross_words_kernel`` (trace_stream.py:117);
                plain version: ``_cross_words_xla`` (:337)
  slot_closest  replaces ``_closest_kernel`` (:812), with ``with_skip`` its
                ``with_skip`` variant; plain: ``closest_walk``
  slot_any      replaces ``_any_kernel`` (:850); plain: ``any_walk``

What the TPU needed and the port does not copy: the static slot budgets
and their tiers (``_run_tiered``, the OV tiers) exist because XLA needs
static shapes.  Here buffers are sized to the wave's true slot demand
(one host read per call, counted in ``STATS``), and only the decisions
that change a result are kept: ``ok`` against the largest tier's budget,
exactly as ``yuki_tpu`` computes it.  ``_pack_stream``'s row-pair table
and lane rolls become one indexed gather; ``slot_fill``'s two row
gathers and variable roll become one index.  uint32 words are held in
int64 tensors.
"""

from __future__ import annotations

import torch

from ..profiling import host_read, pass_scope
from . import _build
from .trace import F32_MAX, ray_shear, scaled_min8, watertight, watertight_scaled

LANES = 128
BIG = 3.0e38
C_MAIN = 16  # candidate-list width
C_WIDE = 128  # overflow re-run width
OV_CAP = 16384  # most overflow rays a wave may re-run
OV_MID = 8192  # the overflow tiers: the re-run's slot budget is
OV_SMALL = 2048  # computed for the smallest of these caps that holds them
WIDE_TIGHT_MULT = 40  # slot-budget multipliers of the wide re-run
WIDE_LOW_MULT = 8
CROSS_2L_MIN_CHUNKS = 1024  # the two-level cull from this many chunks up
CROSS_S = 24  # crossed words per ray in the two-level cull

LAUNCHES = {"cross_words": 0, "slot_closest": 0, "slot_closest_skip": 0,
            "slot_any": 0}
STATS = {"host_syncs": 0, "slot_rows": 0, "bundle_rows": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def host_int(x) -> int:
    """Read a one-element tensor on the host (a device sync on the card),
    counted in STATS and in ``profiling``'s ``host_reads.dispatch``."""
    _build.bump(STATS, "host_syncs")
    return int(host_read(x, "dispatch"))


# --------------------------------------------------------------------
# Slab helpers and crossing words
# --------------------------------------------------------------------


def _safe_inv(dc):
    """Finite slab reciprocal (``_safe_inv``): sign(d) / max(|d|, 1e-30)."""
    tiny = torch.full((), 1e-30, dtype=dc.dtype, device=dc.device)
    return torch.where(dc >= 0.0, 1.0, -1.0) / torch.maximum(dc.abs(), tiny)


def _slab_axis(lo, hi, o, inv, tn, tf):
    """Fold one axis into the slab interval [tn, tf] (``_slab_axis``)."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    return (torch.maximum(tn, torch.minimum(t0, t1)),
            torch.minimum(tf, torch.maximum(t0, t1)))


def n_words(n_chunks: int) -> int:
    return -(-n_chunks // 32)


def word_boxes(cb, n_chunks: int, hi_pad: float):
    """[W, 8] union boxes of each 32-chunk word (lo 0-2, hi 3-5) from the
    chunk bounds ``cb`` [n_chunks, 8].  Pad chunks of the last word carry
    lo = +inf and hi = ``hi_pad``: +inf for the cross-words kernel
    (trace_stream.py:253-271), -inf for the cull (trace_cull.py:242-251).
    Either box holds every real chunk box of its word, so the word cull
    never drops a crossing."""
    w = n_words(n_chunks)
    pad = w * 32 - n_chunks
    dev = cb.device
    lo = torch.cat([cb[:, 0:3], torch.full((pad, 3), float("inf"),
                                           device=dev)]).reshape(w, 32, 3)
    hi = torch.cat([cb[:, 3:6], torch.full((pad, 3), hi_pad,
                                           device=dev)]).reshape(w, 32, 3)
    return torch.cat([lo.amin(dim=1), hi.amax(dim=1),
                      torch.zeros((w, 2), device=dev)], dim=1).contiguous()


def pack_bits(cross):
    """[N, W*32] bool -> [N, W] u32 words (in int64), bit j = column j."""
    n = cross.shape[0]
    shifts = torch.arange(32, dtype=torch.int64, device=cross.device)
    return (cross.reshape(n, -1, 32).to(torch.int64) << shifts).sum(dim=2)


def real_chunks(word_ids, n_chunks: int):
    """Chunks that exist in each word of ``word_ids`` (the last word may
    be partial)."""
    return torch.clamp(n_chunks - 32 * word_ids, 0, 32)


def box_crossings(lo, hi, o, d, t_max):
    """[N, K] bool: ray i's slab interval [0, t_max] meets box k (lo, hi
    [K, 3]), folding x, y, z in order; dead rays (t_max <= 0) cross
    nothing."""
    tn = torch.zeros((o.shape[0], 1), dtype=o.dtype, device=o.device)
    tf = t_max[:, None]
    for a in range(3):
        tn, tf = _slab_axis(lo[None, :, a], hi[None, :, a], o[:, a][:, None],
                            _safe_inv(d[:, a])[:, None], tn, tf)
    return (tn <= tf) & (t_max > 0.0)[:, None]


def cross_words_plain(ch, o, d, t_max, stats=None):
    """Plain version of the crossing words (``_cross_words_xla``): [N, W]
    u32 in int64; bit j of word w is set iff the ray crosses chunk
    32w + j within (0, t_max].  ``stats`` receives "boxes": the slab tests
    the kernel's word cull needs, every word box for each live ray and the
    real chunks of each word whose box it crosses."""
    n_c = ch.n_treelets
    w = n_words(n_c)
    cb = ch.treelet_bounds
    if stats is not None:
        wb = word_boxes(cb, n_c, float("inf"))
        crossed = box_crossings(wb[:, 0:3], wb[:, 3:6], o, d, t_max)
        stats["boxes"] = stats.get("boxes", 0) + int(
            (t_max > 0.0).sum()) * w + int(
            (crossed * real_chunks(torch.arange(w, device=o.device),
                                   n_c)).sum())
    inf = torch.full((w * 32 - n_c, 3), float("inf"), device=o.device)
    return pack_bits(box_crossings(torch.cat([cb[:, 0:3], inf]),
                                   torch.cat([cb[:, 3:6], inf]), o, d, t_max))


def _check_rays(o, d, t_max, dev):
    n = o.shape[0]
    f32 = torch.float32
    _build.check(o, "o", f32, (n, 3), dev)
    _build.check(d, "d", f32, (n, 3), dev)
    _build.check(t_max, "t_max", f32, (n,), dev)
    return n


def cross_tables(ch):
    """The crossing-words kernel's tables, built once per chunk structure
    and kept on it: (word boxes [6, W], chunk boxes [6, 32 W]) f32, lo xyz
    then hi xyz, as structure of arrays.  The word boxes are
    ``word_boxes(..., inf)``'s; the chunk table ends in lo = hi = +inf
    boxes up to whole words, as ``_cross_words_xla`` pads it.  Rebuilt
    when ``ch.treelet_bounds`` is replaced or changed in place."""
    cb = ch.treelet_bounds
    kept = getattr(ch, "_cross_tables", None)
    if kept is not None and kept[0] is cb and kept[1] == cb._version:
        return kept[2]
    n_c = ch.n_treelets
    w = n_words(n_c)
    chunk = torch.cat([cb[:, 0:6], torch.full((w * 32 - n_c, 6), float("inf"),
                                              device=cb.device)])
    tables = (word_boxes(cb, n_c, float("inf"))[:, 0:6].T.contiguous(),
              chunk.T.contiguous())
    ch._cross_tables = (cb, cb._version, tables)
    return tables


def cross_words(ch, o, d, t_max):
    """Exact crossing words [N, W] (u32 in int64) of rays o, d [N,3],
    t_max [N] against the chunk boxes of ``ch``."""
    if not _build.dispatch(o):
        return cross_words_plain(ch, o, d, t_max)
    dev = o.device
    n = _check_rays(o, d, t_max, dev)
    w = n_words(ch.n_treelets)
    _build.check(ch.treelet_bounds, "treelet_bounds", torch.float32,
                 (ch.n_treelets, 8), dev)
    wsoa, csoa = cross_tables(ch)
    words = torch.empty((n, w), dtype=torch.int64, device=dev)
    if n:
        err = _build.library().yk_cross_words(
            dev.index, _build.ptr(wsoa), _build.ptr(csoa), w, _build.ptr(o),
            _build.ptr(d), _build.ptr(t_max), n, _build.ptr(words),
            _build.stream(dev))
        _build.launch_check(err, "cross_words")
        _build.bump(LAUNCHES, "cross_words")
    return words


# --------------------------------------------------------------------
# Candidate lists from words
# --------------------------------------------------------------------


def popcount32(x):
    """Set bits of each u32 held in an int64 tensor (SWAR bit count)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _extract_phase2(words, word_base, C: int):
    """The first C set bits of words [R, w] (u32 in int64) in (column, bit)
    order as chunk ids base + bit (-1 pad) [R, C] i32; ``word_base`` [R, w]
    gives each column's id base, None means column * 32.  yuki_tpu takes
    them by C lowest-set-bit extractions (trace_stream.py:370-399); the
    lowest set bit of the lowest nonzero column is the next bit in that
    order, so ranking the set bits by a prefix count gives the same
    lists."""
    r, w = words.shape
    dev = words.device
    bit = torch.arange(32, dtype=torch.int64, device=dev)
    flat = ((words[:, :, None] >> bit) & 1).reshape(r, w * 32).bool()
    if word_base is None:
        word_base = (torch.arange(w, device=dev) * 32).expand(r, w)
    ids = (word_base.to(torch.int32)[:, :, None] + bit.to(torch.int32)
           ).reshape(r, w * 32)
    rank = torch.cumsum(flat, dim=1, dtype=torch.int32) - 1
    keep = flat & (rank < C)
    out = torch.full((r, C + 1), -1, dtype=torch.int32, device=dev)
    out.scatter_(1, torch.where(keep, rank, C).to(torch.int64),
                 torch.where(keep, ids, -1))
    return out[:, :C]


def extract_compact(words, word_base, C: int):
    """(lists [R, C] i32, overflow [R] bool) from the compacted (words,
    word_base) layout of the two-level cull (``extract_compact``)."""
    count = popcount32(words).sum(dim=1)
    return _extract_phase2(words, word_base, C), count > C


def extract_lists(words, C: int, wc: int | None = None):
    """(lists [R, C] i32 ascending (-1 pad), overflow [R] bool) from dense
    words [R, W] (``extract_lists``, trace_stream.py:411-449).

    With ``wc`` below W the extraction runs in two phases, as yuki_tpu's:
    each row's first ``wc`` nonzero words are compacted (column order
    kept, chunk-id base 32 * column, -32 on pad columns), then the lists
    are drawn from the compacted words.  A row with more than ``wc``
    nonzero words is flagged overflow, like a row with more than C
    candidates; its list holds the candidates of its first ``wc`` nonzero
    words."""
    r, w = words.shape
    overflow = popcount32(words).sum(dim=1) > C
    if wc is None or wc >= w:
        return _extract_phase2(words, None, C), overflow
    nz = words != 0
    overflow = overflow | (nz.sum(dim=1) > wc)
    rank = torch.cumsum(nz, dim=1) - 1
    keep = nz & (rank < wc)
    at = torch.where(keep, rank, wc)
    cols = torch.arange(w, dtype=torch.int64, device=words.device).expand(r, w)
    comp = words.new_zeros((r, wc + 1)).scatter_(1, at, torch.where(keep,
                                                                   words, 0))
    ids = torch.full((r, wc + 1), -1, dtype=torch.int64, device=words.device)
    ids.scatter_(1, at, torch.where(keep, cols, -1))
    return _extract_phase2(comp[:, :wc], ids[:, :wc] * 32, C), overflow


# --------------------------------------------------------------------
# Slot layout and ray stream
# --------------------------------------------------------------------


def slot_layout(n: int, n_chunks: int, lists, C: int, spr: int = LANES):
    """Candidates sorted chunk-major (``slot_layout``): returns (pos_s, seg,
    aligned_off, total_slots) with each chunk's candidates padded to whole
    rows of ``spr`` slots (128; the bundle engine's rows hold 128 // bun
    bundle-slots).  A stable sort; the order within a chunk changes no
    result."""
    dev = lists.device
    keys = torch.where(lists >= 0, lists, n_chunks).reshape(-1)
    keys_s, pos_s = torch.sort(keys, stable=True)
    seg = torch.searchsorted(
        keys_s, torch.arange(n_chunks + 1, dtype=keys_s.dtype, device=dev))
    counts = seg[1:] - seg[:-1]
    aligned = -(-counts // spr) * spr
    aligned_off = torch.cat([torch.zeros(1, dtype=aligned.dtype, device=dev),
                             torch.cumsum(aligned, dim=0)])
    return pos_s, seg, aligned_off, aligned_off[-1]


def slot_fill(n: int, n_chunks: int, pos_s, seg, aligned_off, C: int,
              max_rows: int, spr: int = LANES):
    """Slot rows (``slot_fill``): (slot_pos [max_rows, spr] (candidate
    position ray * C + k, sentinel n * C when empty), row_chunk [max_rows]
    i32, valid [max_rows, spr] bool)."""
    dev = pos_s.device
    total_cap = n * C
    g_tab = aligned_off[:-1] - seg[:-1]
    row_off = aligned_off // spr
    rows_iota = torch.arange(max_rows, dtype=row_off.dtype, device=dev)
    row_chunk = torch.clamp(
        torch.searchsorted(row_off, rows_iota, right=True) - 1,
        0, n_chunks - 1)
    row_start = rows_iota * spr - g_tab[row_chunk]
    lane = torch.arange(spr, dtype=row_off.dtype, device=dev)
    at = row_start[:, None] + lane
    valid = (at < seg[row_chunk + 1][:, None]) & (
        rows_iota[:, None] * spr < aligned_off[-1])
    slot_pos = torch.where(valid, pos_s[torch.clamp(at, 0, total_cap - 1)],
                           total_cap)
    return slot_pos, row_chunk.to(torch.int32), valid


def build_slots(n: int, n_chunks: int, lists, C: int, max_rows: int):
    """``build_slots``: (slot_pos, row_chunk, valid, ok) for a budget of
    ``max_rows`` slot rows; ok is False when the demand exceeds it."""
    pos_s, seg, aligned_off, total = slot_layout(n, n_chunks, lists, C)
    slot_pos, row_chunk, valid = slot_fill(n, n_chunks, pos_s, seg,
                                           aligned_off, C, max_rows)
    return slot_pos, row_chunk, valid, total <= max_rows * LANES


def _pack_stream(o, d, t_max, slot_ray, valid, extra=None):
    """The slots' rays as a [slots, 8] f32 stream (o xyz, d xyz, t, extra)
    by one indexed gather; invalid slots carry t = -1 (``_pack_stream``)."""
    n = o.shape[0]
    ext = (torch.zeros((n, 1), dtype=o.dtype, device=o.device)
           if extra is None else extra.to(o.dtype)[:, None])
    p8 = torch.cat([o, d, t_max[:, None], ext], dim=1)
    stream = p8[slot_ray.reshape(-1)]
    stream[:, 6] = torch.where(valid.reshape(-1), stream[:, 6], -1.0)
    return stream.contiguous()


# --------------------------------------------------------------------
# Slot walks (kernel 12) and their plain versions
# --------------------------------------------------------------------


def _crossing_lanes(stream):
    """The slots whose ray is live (t > 0), their rows' liveness, and the
    rays' planes for those slots."""
    tm = stream[:, 6]
    live_row = (tm > 0.0).reshape(-1, LANES).any(dim=1)
    lanes = torch.nonzero(tm > 0.0).squeeze(1)
    return tm, live_row, lanes, stream[lanes]


def slot_closest_plain(rows, leaf_size: int, row_chunk, stream, stats=None,
                       with_skip=False):
    """Plain version of the closest slot walk (``closest_walk`` under
    ``_closest_kernel``): [3, slots] f32 rows (scaled ts, prim, det).
    Triangle k of the slot's chunk goes to carry k % 8; the carries start
    at (max(t, 0), det 1, prim -1) and take a triangle when
    ts_c * det_b < ts_b * det_c (``with_skip``: and its light id differs
    from the slot's stream column 7); the eight are reduced by scaled_min8.
    A row with no live slot writes (t, -1, 1) (:830-833); only slots with
    t > 0 can take a triangle, so the rest of a live row keeps
    (0, -1, 1).  ``stats`` receives "tests": the real triangles the live
    slots test."""
    tm, live_row, lanes, ray = _crossing_lanes(stream)
    live_slot = live_row.repeat_interleave(LANES)
    out = torch.stack([
        torch.where(live_slot, torch.clamp(tm, min=0.0), tm),
        torch.full_like(tm, -1.0), torch.ones_like(tm)])
    tri = rows.reshape(-1, leaf_size, rows.shape[1])
    chunk = row_chunk.to(torch.int64)[lanes // LANES]
    if stats is not None:
        real = (tri[:, :, 10] >= 0.0).sum(dim=1)
        stats["tests"] = stats.get("tests", 0) + int(real[chunk].sum())
    if lanes.numel() == 0:
        return out
    ox, oy, oz, dx, dy, dz, t0, skip = (ray[:, j] for j in range(8))
    pre = ray_shear(dx, dy, dz)
    ts_b = [torch.clamp(t0, min=0.0)] * 8
    det_b = [torch.ones_like(t0)] * 8
    prim_b = [torch.full_like(t0, -1.0)] * 8
    for k in range(leaf_size):
        c = tri[chunk, k]
        ok, ts_c, det_c = watertight_scaled(pre, ox, oy, oz,
                                            [c[:, j] for j in range(9)])
        s = k % 8
        pid = c[:, 10]
        closer = ok & (pid >= 0.0) & (ts_c * det_b[s] < ts_b[s] * det_c)
        if with_skip:
            closer = closer & (c[:, 9] != skip)
        ts_b[s] = torch.where(closer, ts_c, ts_b[s])
        det_b[s] = torch.where(closer, det_c, det_b[s])
        prim_b[s] = torch.where(closer, pid, prim_b[s])
    ts, det, prim = scaled_min8(torch.stack(ts_b), torch.stack(det_b),
                                torch.stack(prim_b))
    out[:, lanes] = torch.stack([ts, prim, det])
    return out


def slot_any_plain(rows, leaf_size: int, row_chunk, stream, stats=None):
    """Plain version of the occlusion slot walk (``any_walk`` under
    ``_any_kernel``): [slots] i32, 1 where a triangle of the slot's chunk
    with a light id other than the slot's skip id (stream column 7) hits
    within (0, t].  The TPU walk leaves a row once all its live slots are
    occluded; an occluded slot stays occluded, so the result is the OR
    over all triangles.  ``stats`` receives "tests": per live slot, the
    real triangles up to its first occluder."""
    tm, _, lanes, ray = _crossing_lanes(stream)
    occ = torch.zeros(tm.shape[0], dtype=torch.int32, device=tm.device)
    tri = rows.reshape(-1, leaf_size, rows.shape[1])
    chunk = row_chunk.to(torch.int64)[lanes // LANES]
    if lanes.numel() == 0:
        if stats is not None:
            stats["tests"] = stats.get("tests", 0)
        return occ
    ox, oy, oz, dx, dy, dz, t0, skip = (ray[:, j] for j in range(8))
    pre = ray_shear(dx, dy, dz)
    blocked_any = torch.zeros_like(t0, dtype=torch.bool)
    first = torch.full_like(chunk, leaf_size)
    for k in range(leaf_size):
        c = tri[chunk, k]
        ok, ts, det = watertight_scaled(pre, ox, oy, oz,
                                        [c[:, j] for j in range(9)])
        blocked = (ok & (ts <= t0 * det) & (c[:, 9] != skip)
                   & (c[:, 10] >= 0.0))
        first = torch.where(blocked & ~blocked_any, k, first)
        blocked_any |= blocked
    occ[lanes] = blocked_any.to(torch.int32)
    if stats is not None:
        real = (tri[:, :, 10] >= 0.0).sum(dim=1)[chunk]
        stats["tests"] = stats.get("tests", 0) + int(
            torch.where(blocked_any, first + 1, real).sum())
    return occ


def _check_slots(rows, leaf_size, row_chunk, stream, dev):
    n_rows = row_chunk.shape[0]
    _build.check(rows, "rows", torch.float32, (rows.shape[0], 12), dev)
    _build.check(row_chunk, "row_chunk", torch.int32, (n_rows,), dev)
    _build.check(stream, "stream", torch.float32, (n_rows * LANES, 8), dev)
    if leaf_size % 8 or not 8 <= leaf_size <= 256:
        raise ValueError(f"leaf_size {leaf_size}: a multiple of 8 in [8, 256]")
    _build.check_aligned(rows, "rows")
    _build.check_aligned(stream, "stream")
    return n_rows


def slot_closest(rows, leaf_size: int, row_chunk, stream, with_skip=False):
    """Closest slot walk of each 128-slot row against its chunk's
    ``leaf_size`` triangle rows (``rows`` [chunks * leaf_size, 12]).
    ``stream`` [rows * 128, 8] from ``_pack_stream``; ``with_skip``: its
    column 7 holds each slot's skip light id, whose triangles the slot
    ignores.  Returns [3, slots] f32: scaled ts, prim id, det."""
    if not _build.dispatch(stream):
        return slot_closest_plain(rows, leaf_size, row_chunk, stream,
                                  with_skip=with_skip)
    dev = stream.device
    n_rows = _check_slots(rows, leaf_size, row_chunk, stream, dev)
    out = torch.empty((3, n_rows * LANES), dtype=torch.float32, device=dev)
    if n_rows:
        name = "slot_closest_skip" if with_skip else "slot_closest"
        err = _build.library().yk_slot_closest(
            dev.index, _build.ptr(rows), leaf_size, _build.ptr(row_chunk),
            n_rows, _build.ptr(stream), int(with_skip), _build.ptr(out),
            _build.stream(dev))
        _build.launch_check(err, name)
        _build.bump(LAUNCHES, name)
    return out


def slot_any(rows, leaf_size: int, row_chunk, stream):
    """Occlusion slot walk; ``stream`` column 7 carries each slot's skip
    light id.  Returns [slots] i32 (1 = occluded)."""
    if not _build.dispatch(stream):
        return slot_any_plain(rows, leaf_size, row_chunk, stream)
    dev = stream.device
    n_rows = _check_slots(rows, leaf_size, row_chunk, stream, dev)
    occ = torch.empty(n_rows * LANES, dtype=torch.int32, device=dev)
    if n_rows:
        err = _build.library().yk_slot_any(
            dev.index, _build.ptr(rows), leaf_size, _build.ptr(row_chunk),
            n_rows, _build.ptr(stream), _build.ptr(occ), _build.stream(dev))
        _build.launch_check(err, "slot_any")
        _build.bump(LAUNCHES, "slot_any")
    return occ


# --------------------------------------------------------------------
# Budgets, merges and the stream queries
# --------------------------------------------------------------------


def _max_rows(n: int, C: int, n_chunks: int, mult: int) -> int:
    """Slot-row budget (``_max_rows``): mult slots per ray plus every
    chunk's 128-alignment padding, in whole 8-row groups."""
    slots = mult * n + n_chunks * LANES
    return -(-slots // (8 * LANES)) * 8


def _tier_mults(mult, mult_wide):
    """(mult, mult_wide) as the ascending tier list (``_tier_mults``)."""
    ms = list(mult) if isinstance(mult, (tuple, list)) else [mult]
    if mult_wide is not None and mult_wide > ms[-1]:
        ms.append(mult_wide)
    return ms


def _slots(ch, lists, C, mult, mult_wide, budget_n):
    """Lay the candidates out in slot rows sized to the wave's demand.
    Returns None when the demand exceeds the largest tier's budget for
    ``budget_n`` rays (yuki_tpu's ok = False), else (slot_pos, slot_ray,
    row_chunk, valid)."""
    n = lists.shape[0]
    n_c = ch.n_treelets
    pos_s, seg, aligned_off, total = slot_layout(n, n_c, lists, C)
    total = host_int(total)
    cap = _max_rows(budget_n, C, n_c, _tier_mults(mult, mult_wide)[-1])
    if total > cap * LANES:
        return None
    slot_pos, row_chunk, valid = slot_fill(n, n_c, pos_s, seg, aligned_off,
                                           C, total // LANES)
    _build.bump(STATS, "slot_rows", total // LANES)
    slot_ray = torch.where(valid, slot_pos // C, 0)
    return slot_pos, slot_ray, row_chunk, valid


def stream_closest_l(ch, lists, overflow, o, d, t_max, C: int = C_MAIN,
                     mult=6, mult_wide=None, budget_n=None, skip=None):
    """Closest hit over the slot stream from candidate lists [N, C]
    (``stream_closest_l``); ``skip`` [N] i32 (or None): each ray's light
    to ignore, riding stream float 7.  Returns (t, prim i32, overflow,
    ok): t = t_max and prim -1 on a miss; rays flagged ``overflow`` may
    miss hits; when ``ok`` is False (slot demand above the budget for
    ``budget_n`` rays, default N) the results are not computed and the
    caller falls back."""
    n = o.shape[0]
    t_out, prim = t_max.clone(), torch.full_like(t_max, -1, dtype=torch.int32)
    with pass_scope("traverse.layout"):
        slots = _slots(ch, lists, C, mult, mult_wide, n if budget_n is None
                       else budget_n)
        if slots is None:
            return t_out, prim, overflow, False
        slot_pos, slot_ray, row_chunk, valid = slots
        if row_chunk.numel() == 0:
            return t_out, prim, overflow, True
        stream = _pack_stream(o, d, t_max, slot_ray, valid, extra=skip)
    with pass_scope("traverse.walk"):
        out = slot_closest(ch.rows, ch.leaf_size, row_chunk, stream,
                           with_skip=skip is not None)
    with pass_scope("traverse.merge"):
        # One IEEE divide per slot resolves the scaled carry.
        slot_t = out[0] / out[2]
        slot_prim = out[1]
        hitv = valid.reshape(-1) & (slot_prim >= 0.0)
        pos = torch.where(hitv, slot_pos.reshape(-1), n * C)
        tmat = torch.full((n * C + 1,), F32_MAX, device=o.device)
        tmat.scatter_(0, pos, torch.where(hitv, slot_t, F32_MAX))
        pmat = torch.full((n * C + 1,), BIG, device=o.device)
        pmat.scatter_(0, pos, torch.where(hitv, slot_prim, BIG))
        tmat, pmat = tmat[:-1].reshape(n, C), pmat[:-1].reshape(n, C)
        t_win = tmat.amin(dim=1)
        # The lowest prim id among exact-t ties.
        prim_w = torch.where(tmat == t_win[:, None], pmat, BIG).amin(dim=1)
        hit = t_win < F32_MAX
        return (torch.where(hit, t_win, t_max),
                torch.where(hit, prim_w, -1.0).to(torch.int32), overflow,
                True)


def stream_closest_w(ch, words, o, d, t_max, C: int = C_MAIN, mult=6,
                     mult_wide=None, budget_n=None, skip=None):
    """``stream_closest_l`` from dense crossing words."""
    with pass_scope("traverse.cull"):
        lists, overflow = extract_lists(words, C)
    return stream_closest_l(ch, lists, overflow, o, d, t_max, C=C, mult=mult,
                            mult_wide=mult_wide, budget_n=budget_n, skip=skip)


def stream_closest(ch, shading_packed, o, d, t_max, C: int = C_MAIN,
                   mult=6, mult_wide=None, budget_n=None, skip=None):
    """The wide pass's closest hit: crossing words, lists, slot walk and
    barycentrics.  Returns (t, prim, b0, b1, overflow, ok)."""
    with pass_scope("traverse.cull"):
        words = cross_words(ch, o, d, t_max)
    t, prim, overflow, ok = stream_closest_w(
        ch, words, o, d, t_max, C=C, mult=mult, mult_wide=mult_wide,
        budget_n=budget_n, skip=skip)
    with pass_scope("traverse.bary"):
        b0, b1 = _recompute_bary(shading_packed, o, d, t, prim)
    return t, prim, b0, b1, overflow, ok


def stream_any_l(ch, lists, overflow, o, d, t_max, skip_light,
                 C: int = C_MAIN, mult=5, mult_wide=None, budget_n=None):
    """Occlusion over the slot stream (``stream_any_l``).  Returns
    (occluded [N] bool, overflow, ok); as stream_closest_l."""
    n = o.shape[0]
    occ = torch.zeros(n, dtype=torch.bool, device=o.device)
    with pass_scope("traverse.layout"):
        slots = _slots(ch, lists, C, mult, mult_wide, n if budget_n is None
                       else budget_n)
        if slots is None:
            return occ, overflow, False
        _, slot_ray, row_chunk, valid = slots
        if row_chunk.numel() == 0:
            return occ, overflow, True
        stream = _pack_stream(o, d, t_max, slot_ray, valid,
                              extra=skip_light.to(torch.float32))
    with pass_scope("traverse.walk"):
        occ_slot = slot_any(ch.rows, ch.leaf_size, row_chunk, stream) > 0
    with pass_scope("traverse.merge"):
        occ_slot = occ_slot & valid.reshape(-1)
        bucket = torch.where(occ_slot, slot_ray.reshape(-1), n)
        hit = torch.zeros(n + 1, dtype=torch.uint8, device=o.device)
        hit.index_fill_(0, bucket, 1)
        return hit[:n] > 0, overflow, True


def stream_any_w(ch, words, o, d, t_max, skip_light, C: int = C_MAIN,
                 mult=5, mult_wide=None, budget_n=None):
    """``stream_any_l`` from dense crossing words."""
    with pass_scope("traverse.cull"):
        lists, overflow = extract_lists(words, C)
    return stream_any_l(ch, lists, overflow, o, d, t_max, skip_light, C=C,
                        mult=mult, mult_wide=mult_wide, budget_n=budget_n)


def stream_any(ch, o, d, t_max, skip_light, C: int = C_MAIN, mult=5,
               mult_wide=None, budget_n=None):
    """The wide pass's occlusion: crossing words, lists and slot walk.
    Returns (occluded, overflow, ok)."""
    with pass_scope("traverse.cull"):
        words = cross_words(ch, o, d, t_max)
    return stream_any_w(ch, words, o, d, t_max, skip_light, C=C, mult=mult,
                        mult_wide=mult_wide, budget_n=budget_n)


def _recompute_bary(shading_packed, o, d, t, prim):
    """The winning triangle's barycentrics (``_recompute_bary``): the
    watertight test of the hit triangle alone against t * 1.0001 + 1e-6."""
    row = shading_packed[torch.clamp(prim, min=0).to(torch.int64)]
    hit_mask = prim >= 0
    f32 = dict(dtype=torch.float32, device=t.device)
    t_cur = torch.where(hit_mask, t * torch.tensor(1.0001, **f32)
                        + torch.tensor(1e-6, **f32), 0.0)
    _, _, b0, b1 = watertight(o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                              d[:, 2], t_cur, [row[:, c] for c in range(9)])
    return torch.where(hit_mask, b0, 0.0), torch.where(hit_mask, b1, 0.0)
