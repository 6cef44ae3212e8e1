"""Which modules a process has loaded, by whole top-level name.

The port's package name begins with the JAX package's (``yuki_tpu_torch``
and ``yuki_tpu``), so a module is judged by the part of its name before
the first dot, compared whole.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "yuki_tpu")


def top_names(modules=None) -> set:
    mods = sys.modules if modules is None else modules
    return {name.split(".", 1)[0] for name in mods}


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    tops = top_names(modules)
    return sorted(n for n in FORBIDDEN if n in tops)
