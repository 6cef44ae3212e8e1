"""Two-level exact cull: port of ``yuki_tpu/ops/trace_cull.py`` and of its
XLA twin in ``yuki_tpu/ops/trace_stream.py`` (:479-579).

Each ray's candidate list [C] holds the chunks its slab crosses, lowest id
first.  Level 1 tests the union box of every 32-chunk word; level 2 tests
the 32 chunks of each of the ray's first S crossed words; the list is the
first C crossed chunks.  A ray is flagged overflow when it crosses more
than S words or more than C chunks; the caller re-runs it wide.

  candidate_lists_fused  replaces ``_cull_kernel`` (trace_cull.py:60)
  candidate_lists_2l     its plain version: ``cross_compact`` +
                         ``extract_compact``, which yuki_tpu's tests hold
                         bit for bit against the Pallas kernel

A CUDA tensor launches the hand-written kernel in ``csrc/trace_cull.cu``
(word and chunk boxes in shared memory as structure of arrays; level 1 one
thread per ray, level 2 one lane per chunk of each crossed word, a warp's
rays in turn) or raises; a CPU tensor runs the plain version.  The TPU
kernel's one-hot MXU gathers of the chunk bounds are exact ``1.0 * value``
products, so plain loads replace them.  Padding conventions are
yuki_tpu's: level-1 word boxes pad lo = +inf, hi = -inf; level-2 pad
chunks hold BIG and are masked by chunk id.
"""

from __future__ import annotations

import torch

from . import _build
from .trace_stream import (BIG, C_MAIN, CROSS_S, _check_rays, _extract_phase2,
                           _safe_inv, _slab_axis, box_crossings,
                           extract_compact, n_words, pack_bits, real_chunks,
                           word_boxes)

LAUNCHES = {"cull": 0}


def reset_launches() -> None:
    LAUNCHES["cull"] = 0


def _word_tables(ch):
    """Level-1 word boxes (lo [W, 3], hi [W, 3]) and level-2 chunk bounds
    [W, 32, 6] with BIG pad chunks (``_word_tables``)."""
    n_c = ch.n_treelets
    w = n_words(n_c)
    wb = word_boxes(ch.treelet_bounds, n_c, float("-inf"))
    tab = torch.cat([ch.treelet_bounds[:, :6],
                     torch.full((w * 32 - n_c, 6), BIG,
                                device=wb.device)]).reshape(w, 32, 6)
    return wb[:, 0:3], wb[:, 3:6], tab


def cross_compact(ch, o, d, t_max, S: int = CROSS_S, stats=None):
    """(words [N, S] u32 in int64, word_base [N, S] i32 (-32 pad),
    overflow [N] bool): column s holds the chunk crossings of the ray's
    s-th crossed word (``cross_compact``).  ``stats`` receives "boxes":
    the slab tests the cull needs, every word box for each live ray and
    the real chunks of its first S crossed words."""
    n = o.shape[0]
    n_c = ch.n_treelets
    w = n_words(n_c)
    bb_lo, bb_hi, tab = _word_tables(ch)
    live = t_max > 0.0
    inv = [_safe_inv(d[:, a])[:, None] for a in range(3)]
    crossed_w = box_crossings(bb_lo, bb_hi, o, d, t_max)  # [N, w]
    pad_w = n_words(w) * 32 - w
    ww = pack_bits(torch.cat(
        [crossed_w, torch.zeros((n, pad_w), dtype=torch.bool,
                                device=o.device)], dim=1))
    wlists = _extract_phase2(ww, None, S)  # [N, S] word ids, -1 pad
    overflow = crossed_w.sum(dim=1) > S
    if stats is not None:
        real = torch.where(wlists >= 0, real_chunks(wlists, n_c), 0)
        stats["boxes"] = stats.get("boxes", 0) + int(live.sum()) * w + int(
            real.sum())

    j32 = torch.arange(32, device=o.device)
    comp_words, comp_base = [], []
    for s in range(S):
        ids = wlists[:, s].to(torch.int64)
        valid = ids >= 0
        g = tab[torch.clamp(ids, min=0)]  # [N, 32, 6]
        tn = torch.zeros((n, 1), dtype=o.dtype, device=o.device)
        tf = t_max[:, None]
        for a in range(3):
            tn, tf = _slab_axis(g[:, :, a], g[:, :, 3 + a], o[:, a][:, None],
                                inv[a], tn, tf)
        in_range = (ids[:, None] * 32 + j32) < n_c
        cr = (tn <= tf) & valid[:, None] & live[:, None] & in_range
        comp_words.append(pack_bits(cr)[:, 0])
        comp_base.append(torch.where(valid, ids * 32, -32).to(torch.int32))
    return (torch.stack(comp_words, dim=1), torch.stack(comp_base, dim=1),
            overflow)


def candidate_lists_2l(ch, o, d, t_max, C: int = C_MAIN, S: int = CROSS_S,
                       stats=None):
    """Plain version of the cull: (lists [N, C] i32, overflow [N] bool);
    ``stats`` as for cross_compact."""
    cw, cb2, ov1 = cross_compact(ch, o, d, t_max, S, stats)
    lists, ov2 = extract_compact(cw, cb2, C)
    return lists, ov1 | ov2


def _word_tables_kernel(ch):
    """The kernel's level-1 table: [W, 8] word boxes (pad lo = +inf, hi =
    -inf; ``_word_tables_kernel``).  Its level-2 table is the chunk bounds
    themselves, ``ch.treelet_bounds`` [n_chunks, 8], read by chunk id."""
    return word_boxes(ch.treelet_bounds, ch.n_treelets, float("-inf"))


def candidate_lists_fused(ch, o, d, t_max, C: int = C_MAIN,
                          S: int = CROSS_S):
    """Candidate lists by the two-level cull: (lists [N, C] i32 ascending,
    -1 pad; overflow [N] bool)."""
    if not _build.dispatch(o):
        return candidate_lists_2l(ch, o, d, t_max, C, S)
    dev = o.device
    n = _check_rays(o, d, t_max, dev)
    n_c = ch.n_treelets
    _build.check(ch.treelet_bounds, "treelet_bounds", torch.float32, (n_c, 8),
                 dev)
    wb = _word_tables_kernel(ch)
    lists = torch.empty((n, C), dtype=torch.int32, device=dev)
    ov = torch.empty(n, dtype=torch.uint8, device=dev)
    if n:
        err = _build.library().yk_cull(
            dev.index, _build.ptr(wb), wb.shape[0],
            _build.ptr(ch.treelet_bounds), n_c, S, C, _build.ptr(o),
            _build.ptr(d), _build.ptr(t_max), n, _build.ptr(lists),
            _build.ptr(ov), _build.stream(dev))
        _build.launch_check(err, "cull")
        _build.bump(LAUNCHES, "cull")
    return lists, ov > 0
