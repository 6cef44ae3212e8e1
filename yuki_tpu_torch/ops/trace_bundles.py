"""Bundle words: the part of ``yuki_tpu/ops/trace_bundles.py`` that the
bundle walker (``ops/trace_walker.py``) reads.

A bundle is BUN consecutive rays of a wave; its crossing words are the OR
of its rays' exact crossing words (``trace_stream.cross_words``), so its
candidate list is a superset of each of its rays' own.  Any triangle a ray
can hit lies in a chunk that ray's own slab test crosses, so the extra
chunks add no accepted hit: results do not depend on how rays are
bundled.

yuki_tpu's bundle engine built on these words (``bundles_closest_w`` /
``bundles_any_w``, behind ``SceneMeta.bun_closest`` / ``bun_any`` > 1) is
not ported yet; the port's dispatch keeps the per-ray slot stream there.
"""

from __future__ import annotations

import torch

BUN = 8  # rays per bundle


def bundle_words(words: torch.Tensor) -> torch.Tensor:
    """Per-ray crossing words [N, W] (u32 in int64) -> per-bundle OR words
    [N // BUN, W] (``bundle_words``, trace_bundles.py:78-86)."""
    n, w = words.shape
    grouped = words.reshape(n // BUN, BUN, w)
    out = grouped[:, 0].clone()
    for r in range(1, BUN):
        out |= grouped[:, r]
    return out
