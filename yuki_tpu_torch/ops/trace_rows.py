"""The treelet dispatch's probe: port of ``row_words_interval``
(``yuki_tpu/ops/trace_rows.py:58-137``).

The row-union kernels of that module (``_rows_closest_kernel``,
``_rows_any_kernel``) are not ported yet: a wave that the probe calls
coherent takes the treelet walk (``traverse``).
"""

from __future__ import annotations

import torch

from .trace_stream import LANES, n_words, pack_bits


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

    def axis_interval(lo_a, hi_a, olo, ohi, dlo, dhi):
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
