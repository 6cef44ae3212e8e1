"""The bundle engine: port of ``yuki_tpu/ops/trace_bundles.py``.

A bundle is ``bun`` consecutive rays of a sorted wave (bun in {2, 4, 8,
16}); its crossing words are the OR of its rays' exact crossing words
(``trace_stream.cross_words``), so its candidate list is a superset of
each of its rays' own.  The slot stream's layout is regrouped around
(bundle, chunk) candidates: a 128-lane slot row of one chunk holds
spr = 128 // bun bundle-slots, lane j being ray j % bun of bundle-slot
j // bun.  The rows run through the slot stream's own kernels
(``trace_stream.slot_closest`` / ``slot_any``, kernel 12) unchanged.

Any triangle a ray can hit lies in a chunk that ray's own slab test
crosses, so the extra chunks of the OR add no accepted hit: results do
not depend on how rays are bundled.  Each bundle-slot tests all its rays
against the chunk even where only some cross it (the engine's test
amplification); extraction, sort and gather run per bundle instead of per
ray.  yuki_tpu measured the engine 3.2x slower than the per-ray stream on
the TPU and keeps it behind ``SceneMeta.bun_closest`` / ``bun_any`` > 1
(traverse.py:510-518, :738-746), as does the port.

The merges follow yuki_tpu exactly: the closest merge scatters each
bundle-slot's scaled triples (ts, det, prim) to its candidate position and
folds them over the C axis by cross-multiplication (``_scaled_fold``: the
lowest prim id on an exact tie), dividing once per ray at the end; the
occlusion merge is a max over each bundle's slots.  A bundle whose list
was cut at C (or, under ``_auto_wc``, whose words spill the compaction)
flags all its rays overflow; ``ok`` is False when the wave's slot demand
exceeds the widest tier's budget.

What the TPU needed and the port does not copy: ``_bundle_table``'s
bundle-major [n_b, 128] table and ``_pack_bundles``' one 128-wide row
gather per bundle-slot feed the TPU's fast row gather; here one indexed
gather of the rays' eight planes builds the kernels' [rows * 128, 8]
stream.  ``bundle_slot_layout`` and ``bundle_slot_fill`` are the slot
stream's ``slot_layout`` / ``slot_fill`` at ``spr`` slots a row (the
variable roll is plain indexing), and the slot buffers are sized to the
wave's true demand (one host read, counted) instead of the static tiers.
"""

from __future__ import annotations

import torch

from . import _build
from . import trace_stream as ts
from .trace import F32_MAX

LANES = ts.LANES
BUN = 8  # default rays per bundle


def _auto_wc(w: int) -> int | None:
    """The two-phase extraction's cap for wide-word scenes
    (trace_stream.extract_lists): 32 nonzero words above 48 words."""
    return 32 if w > 48 else None


def bundle_words(words: torch.Tensor, bun: int = BUN) -> torch.Tensor:
    """Per-ray crossing words [N, W] (u32 in int64) -> per-bundle OR words
    [N // bun, W] (``bundle_words``, trace_bundles.py:78-86)."""
    n, w = words.shape
    grouped = words.reshape(n // bun, bun, w)
    out = grouped[:, 0].clone()
    for r in range(1, bun):
        out |= grouped[:, r]
    return out


def _max_rows_b(n_b: int, C: int, n_chunks: int, mult: int,
                spr: int) -> int:
    """Bundle-slot-row budget (``_max_rows_b``): ``mult`` candidates per
    bundle plus every chunk's spr alignment padding, in whole 8-row
    groups."""
    slots = mult * n_b + n_chunks * spr
    return -(-slots // (8 * spr)) * 8


def _pack_bundles(o, d, t_max, extra, slot_bun, valid, bun: int):
    """The kernels' [rows * 128, 8] stream of bundle-slot rows: lane j of
    a row carries ray j % bun of bundle-slot j // bun (o, d, t, extra);
    lanes of an empty bundle-slot carry t = -1."""
    lane_ray = (slot_bun.repeat_interleave(bun, dim=1) * bun
                + torch.arange(bun, device=slot_bun.device).repeat(
                    slot_bun.shape[1]))
    return ts._pack_stream(o, d, t_max, lane_ray,
                           valid.repeat_interleave(bun, dim=1), extra)


def _scaled_fold(C: int, ts_, det, prim):
    """Reduce [n_b, C, bun] scaled-hit triples over the C axis in order:
    the smallest ts / det wins by cross-multiplication, the lowest prim id
    on an exact tie (no divides).  Returns (ts, det, prim) [n_b, bun]."""
    b_ts, b_det, b_prim = ts_[:, 0], det[:, 0], prim[:, 0]
    for c in range(1, C):
        c_ts, c_det, c_prim = ts_[:, c], det[:, c], prim[:, c]
        lhs = c_ts * b_det
        rhs = b_ts * c_det
        closer = (lhs < rhs) | ((lhs == rhs) & (c_prim < b_prim))
        b_ts = torch.where(closer, c_ts, b_ts)
        b_det = torch.where(closer, c_det, b_det)
        b_prim = torch.where(closer, c_prim, b_prim)
    return b_ts, b_det, b_prim


def _bundle_slots(ch, bwords, C: int, mult: int, mult_wide, bun: int):
    """Extraction, layout and rows sized to the demand.  Returns
    (overflow per bundle, None) when the demand exceeds the widest tier's
    budget, else (overflow, (slot_pos, slot_bun, row_chunk, valid))."""
    n_b = bwords.shape[0]
    spr = LANES // bun
    n_c = ch.n_treelets
    lists, ov_b = ts.extract_lists(bwords, C, wc=_auto_wc(bwords.shape[1]))
    pos_s, seg, aligned_off, total = ts.slot_layout(n_b, n_c, lists, C, spr)
    total = ts.host_int(total)
    widest = mult_wide if mult_wide is not None and mult_wide > mult else mult
    if total > _max_rows_b(n_b, C, n_c, widest, spr) * spr:
        return ov_b, None
    slot_pos, row_chunk, valid = ts.slot_fill(n_b, n_c, pos_s, seg,
                                              aligned_off, C, total // spr,
                                              spr)
    _build.bump(ts.STATS, "bundle_rows", total // spr)
    return ov_b, (slot_pos, torch.where(valid, slot_pos // C, 0), row_chunk,
                  valid)


def bundles_closest_w(ch, bwords, o, d, t_max, *, C: int, mult: int,
                      bun: int, mult_wide: int | None = None):
    """Closest hit over the bundle-slot stream from per-bundle OR words
    [N // bun, W] (``bundles_closest_w``).  Returns (t, prim i32,
    overflow [N], ok) as ``trace_stream.stream_closest_w``: t = t_max and
    prim -1 on a miss; overflow marks every ray of a bundle whose list was
    cut; with ok False the results are not computed."""
    n = o.shape[0]
    n_b = n // bun
    ov_b, slots = _bundle_slots(ch, bwords, C, mult, mult_wide, bun)
    overflow = ov_b.repeat_interleave(bun)
    t_out, prim_out = t_max.clone(), torch.full_like(t_max, -1,
                                                     dtype=torch.int32)
    if slots is None:
        return t_out, prim_out, overflow, False
    slot_pos, slot_bun, row_chunk, valid = slots
    rows = row_chunk.shape[0]
    if rows == 0:
        return t_out, prim_out, overflow, True
    out = ts.slot_closest(ch.rows, ch.leaf_size, row_chunk,
                          _pack_bundles(o, d, t_max, None, slot_bun, valid,
                                        bun))
    spr = LANES // bun
    s_ts, s_prim, s_det = (x.reshape(rows, spr, bun) for x in out)
    miss = ~valid[..., None] | (s_prim < 0.0)
    s_ts = torch.where(miss, F32_MAX, s_ts)
    s_det = torch.where(miss, 1.0, s_det)
    s_prim = torch.where(miss, ts.BIG, s_prim)
    # Each bundle-slot's triples go to its candidate position (unique);
    # empty slots to the dropped sentinel row n_b * C.
    pos = torch.where(valid, slot_pos, n_b * C).reshape(-1)

    def scat(v, fill):
        mat = torch.full((n_b * C + 1, bun), fill, dtype=torch.float32,
                         device=o.device)
        mat[pos] = v.reshape(-1, bun)
        return mat[:-1].reshape(n_b, C, bun)

    b_ts, b_det, b_prim = _scaled_fold(C, scat(s_ts, F32_MAX),
                                       scat(s_det, 1.0), scat(s_prim, ts.BIG))
    hit = b_prim < ts.BIG
    # One IEEE divide per ray resolves the scaled winner.
    t_out = torch.where(hit, b_ts / b_det, t_max.reshape(n_b, bun))
    prim_out = torch.where(hit, b_prim, -1.0).to(torch.int32)
    return t_out.reshape(n), prim_out.reshape(n), overflow, True


def bundles_any_w(ch, bwords, o, d, t_max, skip_light, *, C: int,
                  mult: int, bun: int, mult_wide: int | None = None):
    """Occlusion over the bundle-slot stream (``bundles_any_w``); the
    triangles of each ray's ``skip_light`` [N] i32 are ignored.  Returns
    (occluded [N] bool, overflow [N], ok) as ``stream_any_w``."""
    n = o.shape[0]
    n_b = n // bun
    ov_b, slots = _bundle_slots(ch, bwords, C, mult, mult_wide, bun)
    overflow = ov_b.repeat_interleave(bun)
    occ = torch.zeros(n, dtype=torch.bool, device=o.device)
    if slots is None:
        return occ, overflow, False
    _, slot_bun, row_chunk, valid = slots
    rows = row_chunk.shape[0]
    if rows == 0:
        return occ, overflow, True
    stream = _pack_bundles(o, d, t_max, skip_light.to(torch.float32),
                           slot_bun, valid, bun)
    spr = LANES // bun
    s_occ = ts.slot_any(ch.rows, ch.leaf_size, row_chunk, stream).reshape(
        rows, spr, bun)
    s_occ = torch.where(valid[..., None], s_occ, 0)
    # The max of 0/1 verdicts over each bundle's slots (several slots
    # share a bundle), as a count > 0; empty slots go to the dropped row.
    flat = torch.where(valid, slot_bun, n_b).reshape(-1)
    occ_b = torch.zeros((n_b + 1, bun), dtype=torch.int32, device=o.device)
    occ_b.index_add_(0, flat, s_occ.reshape(-1, bun))
    return occ_b[:n_b].reshape(n) > 0, overflow, True
