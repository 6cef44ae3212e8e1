"""Device ms a traced frame of the treelet dispatch's kernels: the
``__global__`` functions of its CUDA sources (the row walks, the slot
stream, the cull, the treelet walks, the bundle walker and the pair
walks), read from the checkout at run time.  None where no such kernel
ran (a dense scene's run)."""

import os
import re

from ..harness import ROOT
from ..trace import own_kernel_matcher

SOURCES = ("trace_rows.cu", "trace_stream.cu", "trace_cull.cu",
           "trace_treelets.cu", "trace_walker.cu", "trace_pairs.cu")
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?(\w+)\s*\(", re.S)


def kernel_names(root: str = ROOT) -> set:
    """The ``__global__`` functions of ``SOURCES`` under ``root``."""
    csrc = os.path.join(root, "yuki_tpu_torch", "ops", "csrc")
    names = set()
    for fn in SOURCES:
        path = os.path.join(csrc, fn)
        if os.path.exists(path):
            with open(path) as f:
                names.update(_GLOBAL.findall(f.read()))
    return names


def read(r):
    t = r["trace"]
    if t is None or not t.frames:
        return None
    secs = t.kernel_seconds(own_kernel_matcher(kernel_names()))
    return secs * 1e3 / t.frames if secs > 0 else None
