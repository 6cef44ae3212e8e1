"""Integrator parameters (port of ``yuki_tpu/integrators/__init__.py:40-42``).

Only the path tracer's parameters are ported: the dense path-tracing wave
(``ops/path_fused.py``) is the path tracer for dense scenes.  Whitted, the
debug integrators and the XLA ``path_li`` chain come later (ROADMAP
Queue 1 items 8 and 10).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class PathParams:
    max_depth: int = 3
    indirect_clamp: Optional[float] = None
