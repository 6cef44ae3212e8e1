"""Block-pair treelet walks: port of ``yuki_tpu/ops/trace_pairs.py``, the
block-sparse form of the treelet walk.

Rays go in blocks of 1024 consecutive rays (BLOCK_ROWS rows of 128).
``block_candidate_pairs`` culls each block's bundle (origin box, per-axis
direction interval, largest t_max) against every treelet box by interval
arithmetic, conservatively, and lists the surviving (block, treelet) pairs
block-major, each block's pairs front to back by their conservative
t_enter; every block keeps its pair with treelet 0.  A block then walks its
run of pairs in order: a treelet is visited when some lane's slab test of
its box passes against that lane's running t (``_recheck``, the plain 1 / d
slab of ``trace_treelets._slab``), and then every lane tests its rows.

  pairs_closest_walk  replaces ``_pairs_kernel`` (trace_pairs.py:176): the
                      closest hit by the direct-t watertight test, taking a
                      row when it hits within the running t, ti < t and its
                      prim id is >= 0; plain: ``pairs_closest_plain``
  pairs_any_walk      replaces ``_pairs_any_kernel`` (:219): occlusion,
                      ORing hits of real rows whose light id differs from
                      the lane's skip id (a float compare); a visited
                      treelet's rows are left after the first row at which
                      every lane that crosses its box is occluded; plain:
                      ``pairs_any_plain``

A CUDA tensor launches the hand-written kernel in ``csrc/trace_pairs.cu``
(one 1024-thread CUDA block per ray block, longest run first; votes on
windows of 32 pairs; framed rows up to each treelet's last real row; the
occlusion walk's exit row r* found once) or raises; a CPU tensor runs the
plain PyTorch version beside it.  Each kernel launch adds one to
``LAUNCHES``.

What the TPU needed and the port does not copy: the walk in CHUNK-pair
launches (an SMEM limit on the prefetched pair arrays) with a min-t merge
of a block's results across launches.  The port walks each block's whole
run in one launch; yuki_tpu's result does not depend on the chunking
(tests/test_pairs.py TestChunking), so neither does the port's.  The pair
list keeps yuki_tpu's capacity contract: past ``max_pairs`` pairs are
dropped and ``n_pairs`` tells the caller to fall back.  ``lax.sort`` in
yuki_tpu orders pairs of equal t_enter arbitrarily (it is not stable);
the port orders them by treelet id.  Treelet rows are the port's [T*K, 12]
table, whose columns 0-10 are yuki_tpu's ``tris_padded``.
"""

from __future__ import annotations

import torch

from . import _build
from .trace_rows import axis_interval
from .trace_stream import LANES
from .trace_treelets import (BLOCK, _accept_in_order, _edge_terms,
                             _in_range, _Rays, _slab)

BLOCK_ROWS = BLOCK // LANES  # 8 rows of 128 rays per block
CHUNK = 8192  # pairs per TPU launch
MAX_CHUNKS = 48  # TPU launches per walk: the default capacity is
# CHUNK * MAX_CHUNKS pairs

LAUNCHES = {"pairs_closest": 0, "pairs_any": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def block_candidate_pairs(tl, o, d, t_max, max_pairs: int):
    """The conservative block-vs-treelet cull (``block_candidate_pairs``):
    (pair_block [max_pairs] i32, pair_treelet [max_pairs] i32, n_pairs,
    n_blocks).  The first min(n_pairs, max_pairs) entries are the pairs in
    (block, t_enter, treelet) order; padding entries point at block
    n_blocks (the dummy block of ``_pack_rays``) and treelet 0.  ``n_pairs``
    counts every surviving pair (a host read)."""
    n = o.shape[0]
    rows = max(-(-n // LANES), 1)
    n_blocks = -(-rows // BLOCK_ROWS)
    pad = n_blocks * BLOCK - n
    dev = o.device

    def blocks_of(x, fill):
        return torch.cat([x, x.new_full((pad,), fill)]).reshape(n_blocks,
                                                                BLOCK)

    # Padding lanes (origin 0, direction 1, t_max 0) only widen the
    # intervals: conservative, never wrong.
    o_lo = torch.stack([blocks_of(o[:, k], 0.0).amin(dim=1)
                        for k in range(3)], 1)[:, None, :]
    o_hi = torch.stack([blocks_of(o[:, k], 0.0).amax(dim=1)
                        for k in range(3)], 1)[:, None, :]
    d_lo = torch.stack([blocks_of(d[:, k], 1.0).amin(dim=1)
                        for k in range(3)], 1)[:, None, :]
    d_hi = torch.stack([blocks_of(d[:, k], 1.0).amax(dim=1)
                        for k in range(3)], 1)[:, None, :]
    t_hi = blocks_of(t_max, 0.0).amax(dim=1)

    lo = tl.treelet_bounds[None, :, 0:3]
    hi = tl.treelet_bounds[None, :, 3:6]
    ens, exs = zip(*(axis_interval(lo[..., a], hi[..., a], o_lo[..., a],
                                   o_hi[..., a], d_lo[..., a], d_hi[..., a])
                     for a in range(3)))
    t_enter = torch.maximum(torch.maximum(ens[0], ens[1]), ens[2])
    t_exit = torch.minimum(torch.minimum(exs[0], exs[1]), exs[2])
    zero = torch.zeros((), device=dev)
    hit = torch.maximum(t_enter, zero) <= torch.minimum(t_exit,
                                                        t_hi[:, None])
    # Every block keeps a pair, so that its lanes' results are written.
    hit[:, 0] = True

    n_t = tl.n_treelets
    sel = torch.nonzero(hit.reshape(-1)).squeeze(1)  # block-major
    n_pairs = sel.numel()
    sel = sel[:max_pairs]
    t_en = torch.where(torch.isnan(t_enter), float("inf"),
                       torch.maximum(t_enter, zero)).reshape(-1)[sel]
    blk, tt = sel // n_t, sel % n_t
    # Front to back within each block, equal t_enter by treelet id: two
    # stable sorts of the (block, treelet)-ordered list.
    by_t = torch.argsort(t_en, stable=True)
    order = by_t[torch.argsort(blk[by_t], stable=True)]
    fill = max_pairs - sel.numel()
    pair_block = torch.cat([blk[order], blk.new_full((fill,), n_blocks)])
    pair_treelet = torch.cat([tt[order], tt.new_zeros(fill)])
    return (pair_block.to(torch.int32), pair_treelet.to(torch.int32),
            n_pairs, n_blocks)


def _pack_rays(o, d, t_max, n_blocks, extra=None):
    """The rays as one [(n_blocks + 1) * 8, 7 * 128 (+ 128)] f32 table
    (``_pack_rays``): plane p of ray r at row r // 128, column p * 128 +
    r % 128 (o xyz, d xyz, t_max, then ``extra``, the skip ids).  Padding
    lanes carry origin 0, direction 1, t_max 0, skip -2; the trailing dummy
    block (origin and direction 1, t_max -1, skip -2), where padding pairs
    point, fails every recheck."""
    n = o.shape[0]
    rows = n_blocks * BLOCK_ROWS
    pad = rows * LANES - n

    def plane(x, cv, fill):
        x = torch.cat([x.to(torch.float32), x.new_full((pad,), cv,
                                                       dtype=torch.float32)])
        return torch.cat([x.reshape(rows, LANES),
                          x.new_full((BLOCK_ROWS, LANES), fill)])

    cols = [plane(o[:, k], 0.0, 1.0) for k in range(3)]
    cols += [plane(d[:, k], 1.0, 1.0) for k in range(3)]
    cols.append(plane(t_max, 0.0, -1.0))
    if extra is not None:
        cols.append(plane(extra, -2.0, -2.0))
    return torch.cat(cols, dim=1).contiguous()


def pair_runs(pair_block, n_walk: int, n_blocks: int):
    """[n_blocks + 1] i32 offsets: block b walks the pairs [runs[b],
    runs[b + 1]) of the first ``n_walk`` (a block-major list)."""
    bounds = torch.arange(n_blocks + 1, dtype=torch.int32,
                          device=pair_block.device)
    return torch.searchsorted(pair_block[:n_walk].contiguous(),
                              bounds).to(torch.int32)


# --------------------------------------------------------------------
# Plain versions of the two walks
# --------------------------------------------------------------------


def _block_planes(packed, n_blocks):
    """The packed table's planes, each [n_blocks, BLOCK] (dummy block
    dropped)."""
    w = packed.shape[1] // LANES
    p = packed[:n_blocks * BLOCK_ROWS].reshape(n_blocks, BLOCK_ROWS, w, LANES)
    return [p[:, :, k, :].reshape(n_blocks, BLOCK) for k in range(w)]


def _pair_steps(tl, runs, pair_treelet):
    """For j = 0, 1, ...: (blocks with a j-th pair, their j-th treelets)."""
    counts = runs[1:] - runs[:-1]
    for j in range(int(counts.max()) if counts.numel() else 0):
        on = torch.nonzero(counts > j).squeeze(1)
        yield on, pair_treelet[(runs[on] + j).long()].long()


def _tally(stats, key, value) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(value)


def pairs_closest_plain(tl, runs, pair_treelet, packed, stats=None):
    """Plain version of the closest pair walk (``_pairs_kernel``): (t, prim
    i32, b0, b1) over the n_blocks * 1024 lanes of ``packed``, n_blocks =
    len(runs) - 1.  Each block starts at (t_max, -1, 0, 0) and walks its
    run; the rows of a visited treelet are accepted in order per lane
    (``trace_treelets._accept_in_order``).
    ``stats`` receives "boxes" (pair box tests of lanes with t_max > 0),
    "tests" (such lanes against the real rows of the treelets whose box
    their own slab test passes), "treelets" (distinct treelets visited),
    "pairs", "visited" (pairs the block visits), "live" (lanes with t_max
    > 0 summed over the visited pairs) and "forced" (the tests the
    block's contract forces: each visited pair's live lanes against its
    treelet's real rows)."""
    nb = runs.shape[0] - 1
    ox, oy, oz, dx, dy, dz, tm = _block_planes(packed, nb)[:7]
    rays = _Rays(ox, oy, oz, dx, dy, dz)
    t = tm.clone()
    prim = torch.full_like(tm, -1, dtype=torch.int32)
    b0, b1 = torch.zeros_like(tm), torch.zeros_like(tm)
    k = tl.leaf_size
    rows = tl.rows.reshape(tl.n_treelets, k, -1)
    real = (rows[:, :, 10] >= 0.0).sum(dim=1)
    live = tm > 0.0
    seen = torch.zeros(tl.n_treelets, dtype=torch.bool, device=tm.device)
    for on, tt in _pair_steps(tl, runs, pair_treelet):
        box = tl.treelet_bounds[tt].T[:, :, None]
        lane = _slab(box, *(x[on] for x in rays.o),
                     *(x[on] for x in rays.inv), t[on])
        _tally(stats, "boxes", live[on].sum())
        _tally(stats, "tests",
               ((lane & live[on]).sum(dim=1) * real[tt]).sum())
        visit = lane.any(dim=1)
        vb, tv = on[visit], tt[visit]
        _tally(stats, "pairs", on.numel())
        _tally(stats, "visited", vb.numel())
        if vb.numel() == 0:
            continue
        _tally(stats, "live", live[vb].sum())
        _tally(stats, "forced", (live[vb].sum(dim=1) * real[tv]).sum())
        seen[tv] = True
        tri = rows[tv]
        t[vb], prim[vb], b0[vb], b1[vb] = _accept_in_order(
            tri, _edge_terms(rays.lanes(vb, flat=False), tri),
            t[vb], prim[vb], b0[vb], b1[vb])
    _tally(stats, "treelets", seen.sum())
    return t.reshape(-1), prim.reshape(-1), b0.reshape(-1), b1.reshape(-1)


def pairs_any_plain(tl, runs, pair_treelet, packed, stats=None):
    """Plain version of the occlusion pair walk (``_pairs_any_kernel``):
    [n_blocks * 1024] bool.  A block visits a treelet when one of its
    unoccluded lanes crosses its box (slab against t_max); it ORs each
    row's blocking hits into every lane and leaves the treelet after the
    first row at which no crossing lane is unoccluded.  ``stats``: "boxes"
    (box tests of unoccluded lanes with t_max > 0), "tests" (each crossing
    unoccluded lane's rows up to its first occluder, else every real row),
    "treelets", "pairs", "visited", "live" (unoccluded lanes with t_max >
    0 summed over the visited pairs) and "forced" (the tests the exit rule
    forces: each such lane's rows up to its first occluder, within the
    real rows for a crossing lane and the rows walked for the others)."""
    nb = runs.shape[0] - 1
    ox, oy, oz, dx, dy, dz, tm, skip = _block_planes(packed, nb)[:8]
    rays = _Rays(ox, oy, oz, dx, dy, dz)
    occ = torch.zeros_like(tm, dtype=torch.bool)
    k = tl.leaf_size
    rows = tl.rows.reshape(tl.n_treelets, k, -1)
    real = (rows[:, :, 10] >= 0.0).sum(dim=1)
    live = tm > 0.0
    seen = torch.zeros(tl.n_treelets, dtype=torch.bool, device=tm.device)
    row_k = torch.arange(k, device=tm.device)
    for on, tt in _pair_steps(tl, runs, pair_treelet):
        box = tl.treelet_bounds[tt].T[:, :, None]
        crossing = _slab(box, *(x[on] for x in rays.o),
                         *(x[on] for x in rays.inv), tm[on])
        alive = crossing & ~occ[on]
        _tally(stats, "boxes", (live[on] & ~occ[on]).sum())
        visit = alive.any(dim=1)
        vb, tv, cross = on[visit], tt[visit], crossing[visit]
        _tally(stats, "pairs", on.numel())
        _tally(stats, "visited", vb.numel())
        if vb.numel() == 0:
            continue
        seen[tv] = True
        tri = rows[tv]
        base_ok, det, t_scaled = _edge_terms(rays.lanes(vb, flat=False),
                                             tri)[:3]
        hit = base_ok & _in_range(det, t_scaled, tm[vb][:, None, :])
        blocked = (hit & (tri[:, :, 9, None] != skip[vb][:, None, :])
                   & (tri[:, :, 10, None] >= 0.0))
        occ0 = occ[vb]
        # Every lane's occlusion after each row, and whether a crossing
        # lane is still unoccluded then; the walk stops after the first
        # row where none is.
        after = occ0[:, None, :] | (torch.cummax(blocked.to(torch.int32),
                                                 dim=1).values > 0)
        still = (cross[:, None, :] & ~after).any(dim=2)
        stop = torch.where(still, k - 1, row_k).amin(dim=1)
        if stats is not None:
            first = torch.where(blocked.any(dim=1),
                                blocked.to(torch.int32).argmax(dim=1) + 1,
                                real[tv][:, None])
            need = cross & ~occ0 & live[vb]
            _tally(stats, "tests", (first * need).sum())
            open_ = ~occ0 & live[vb]
            walked = torch.minimum(stop + 1, real[tv])[:, None]
            _tally(stats, "live", open_.sum())
            _tally(stats, "forced", torch.where(
                cross, first, torch.minimum(first, walked))[open_].sum())
        occ[vb] = after.gather(1, stop[:, None, None].expand(
            -1, 1, BLOCK))[:, 0]
    _tally(stats, "treelets", seen.sum())
    return occ.reshape(-1)


# --------------------------------------------------------------------
# Kernel wrappers and the two queries
# --------------------------------------------------------------------


def _check_walk(tl, runs, pair_treelet, packed, planes, dev):
    nb = runs.shape[0] - 1
    f32 = torch.float32
    k = tl.leaf_size
    if not 1 <= k <= 256:
        raise ValueError(f"leaf_size {k} outside [1, 256]")
    _build.check(runs, "runs", torch.int32, (nb + 1,), dev)
    _build.check(pair_treelet, "pair_treelet", torch.int32,
                 (pair_treelet.shape[0],), dev)
    _build.check(packed, "packed", f32, (packed.shape[0], planes * LANES),
                 dev)
    if packed.shape[0] < nb * BLOCK_ROWS:
        raise ValueError(f"packed has {packed.shape[0]} rows for {nb} blocks")
    _build.check(tl.treelet_bounds, "treelet_bounds", f32,
                 (tl.n_treelets, 8), dev)
    _build.check(tl.rows, "rows", f32, (tl.n_treelets * k, 12), dev)
    return nb


def _block_order(runs):
    """The ray blocks longest run first (ties in block order), the order
    the kernels' CUDA blocks take them in."""
    return torch.argsort(runs[1:] - runs[:-1], descending=True,
                         stable=True).to(torch.int32)


def pairs_closest_walk(tl, runs, pair_treelet, packed, n: int):
    """Closest hits of the first ``n`` lanes of ``packed`` (``_pack_rays``,
    7 planes) by the pair walk over ``runs`` (``pair_runs``) and
    ``pair_treelet``.  Returns (t, prim i32, b0, b1) [n]."""
    if not _build.dispatch(packed):
        return tuple(x[:n] for x in pairs_closest_plain(
            tl, runs, pair_treelet, packed))
    dev = packed.device
    nb = _check_walk(tl, runs, pair_treelet, packed, 7, dev)
    n = min(n, nb * BLOCK)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    b0, b1 = torch.empty_like(t), torch.empty_like(t)
    if nb:
        order = _block_order(runs)
        err = _build.library().yk_pairs_closest(
            dev.index, _build.ptr(tl.treelet_bounds), _build.ptr(tl.rows),
            tl.leaf_size, _build.ptr(runs), _build.ptr(pair_treelet),
            _build.ptr(order), nb, _build.ptr(packed), n,
            _build.ptr(t), _build.ptr(prim),
            _build.ptr(b0), _build.ptr(b1), _build.stream(dev))
        _build.launch_check(err, "pairs_closest")
        _build.bump(LAUNCHES, "pairs_closest")
    return t, prim, b0, b1


def pairs_any_walk(tl, runs, pair_treelet, packed, n: int):
    """Occlusion [n] bool of the first ``n`` lanes of ``packed`` (8 planes:
    the skip ids last) by the pair walk."""
    if not _build.dispatch(packed):
        return pairs_any_plain(tl, runs, pair_treelet, packed)[:n]
    dev = packed.device
    nb = _check_walk(tl, runs, pair_treelet, packed, 8, dev)
    n = min(n, nb * BLOCK)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    if nb:
        order = _block_order(runs)
        err = _build.library().yk_pairs_any(
            dev.index, _build.ptr(tl.treelet_bounds), _build.ptr(tl.rows),
            tl.leaf_size, _build.ptr(runs), _build.ptr(pair_treelet),
            _build.ptr(order), nb, _build.ptr(packed), n,
            _build.ptr(occ), _build.stream(dev))
        _build.launch_check(err, "pairs_any")
        _build.bump(LAUNCHES, "pairs_any")
    return occ


def pairs_closest(tl, o, d, t_max, max_pairs: int = CHUNK * MAX_CHUNKS):
    """Closest hit by the pair walk (``pairs_closest``).  Returns (t, prim
    i32, b0, b1, n_pairs); past ``max_pairs`` pairs the results may miss
    hits and the caller falls back."""
    pb, pt, n_pairs, nb = block_candidate_pairs(tl, o, d, t_max, max_pairs)
    runs = pair_runs(pb, min(n_pairs, max_pairs), nb)
    t, prim, b0, b1 = pairs_closest_walk(tl, runs, pt,
                                         _pack_rays(o, d, t_max, nb),
                                         o.shape[0])
    return t, prim, b0, b1, n_pairs


def pairs_any(tl, o, d, t_max, skip_light,
              max_pairs: int = CHUNK * MAX_CHUNKS):
    """Occlusion by the pair walk (``pairs_any``); ``skip_light`` [N] i32.
    Returns (occluded [N] bool, n_pairs)."""
    pb, pt, n_pairs, nb = block_candidate_pairs(tl, o, d, t_max, max_pairs)
    runs = pair_runs(pb, min(n_pairs, max_pairs), nb)
    occ = pairs_any_walk(tl, runs, pt, _pack_rays(o, d, t_max, nb,
                                                  skip_light), o.shape[0])
    return occ, n_pairs
