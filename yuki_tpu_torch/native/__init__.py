"""Host-side native code of the port, built at first use and bound with
``ctypes``: the SAH/middle/equal-counts BVH builder (``bvh_builder.cpp``,
a copy of ``yuki_tpu/native/bvh_builder.cpp``).

``g++ -O2 -shared -fPIC -std=c++17`` builds it into ``build/yuki_tpu_torch/``
at the repository root (not into the package), named by a hash of the
source and flags.  ``locked_build`` serialises concurrent builders (the
tests run several worker processes at once) with a file lock and renames
the finished library into place atomically; ``ops/_build.py`` builds the
CUDA library the same way.  A failed build raises: there is no Python
fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable

import numpy as np

SRC = Path(__file__).resolve().parent / "bvh_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "yuki_tpu_torch"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_SPLIT_IDS = {"sah": 0, "middle": 1, "equal_counts": 2}

_lock = threading.Lock()
_lib = None


def locked_build(target: Path, build: Callable[[str], None]) -> None:
    """Make ``target`` unless it exists: ``build(tmp_path)`` writes the
    file, which is then renamed onto ``target``.  A lock file beside the
    target keeps two processes from building it at once."""
    if target.exists():
        return
    target.parent.mkdir(parents=True, exist_ok=True)
    with open(target.parent / (target.name + ".lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if target.exists():  # built by another process meanwhile
                return
            fd, tmp = tempfile.mkstemp(suffix=target.suffix, dir=target.parent)
            os.close(fd)
            try:
                build(tmp)
                os.replace(tmp, target)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def _compile(tmp: str) -> None:
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, str(SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed ({proc.returncode}) building {SRC.name}:\n"
            f"{proc.stdout}\n{proc.stderr}"
        )


def library() -> ctypes.CDLL:
    """The loaded BVH library, built first if needed.  Raises if the build
    or the load fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
        h.update(SRC.read_bytes())
        so = BUILD_DIR / f"libyuki_bvh_{h.hexdigest()[:16]}.so"
        locked_build(so, _compile)
        lib = ctypes.CDLL(str(so))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.build_bvh.restype = ctypes.c_int
        lib.build_bvh.argtypes = [
            f32p, f32p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, f32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p, i64p,
        ]
        lib.thread_links.restype = ctypes.c_int
        lib.thread_links.argtypes = [i32p, i32p, i32p, i32p, ctypes.c_int64,
                                     i32p]
        _lib = lib
        return lib


def native_build_bvh(lo: np.ndarray, hi: np.ndarray, split_method: str,
                     max_shapes_in_node: int, max_leaf_size: int) -> dict:
    """Build over per-primitive boxes lo/hi [n,3] f32; returns the BvhHost
    field dict (node arrays, prim_order, octant links)."""
    if split_method not in _SPLIT_IDS:
        raise ValueError(f"unknown split method {split_method!r}")
    lib = library()
    n = lo.shape[0]
    lo = np.ascontiguousarray(lo, dtype=np.float32)
    hi = np.ascontiguousarray(hi, dtype=np.float32)
    cap = 2 * n
    node_lo = np.empty((cap, 3), np.float32)
    node_hi = np.empty((cap, 3), np.float32)
    ints = {k: np.empty(cap, np.int32) for k in (
        "prim_offset", "prim_count", "child0", "child1", "axis", "depth")}
    prim_order = np.empty(n, np.int32)
    n_nodes = ctypes.c_int64(0)

    def p(a, t=ctypes.c_float):
        return a.ctypes.data_as(ctypes.POINTER(t))

    i32 = ctypes.c_int32
    rc = lib.build_bvh(
        p(lo), p(hi), n,
        _SPLIT_IDS[split_method], max_shapes_in_node, max_leaf_size,
        p(node_lo), p(node_hi),
        p(ints["prim_offset"], i32), p(ints["prim_count"], i32),
        p(ints["child0"], i32), p(ints["child1"], i32),
        p(ints["axis"], i32), p(ints["depth"], i32),
        p(prim_order, i32), ctypes.byref(n_nodes),
    )
    if rc != 0:
        raise RuntimeError(f"native build_bvh returned {rc} for {n} prims")
    m = n_nodes.value
    links = np.empty((8, m, 2), np.int32)
    lib.thread_links(p(ints["child0"], i32), p(ints["child1"], i32),
                     p(ints["axis"], i32), p(ints["prim_count"], i32),
                     m, p(links, i32))
    out = {k: v[:m].copy() for k, v in ints.items()}
    out.update(links=links, node_lo=node_lo[:m].copy(),
               node_hi=node_hi[:m].copy(), prim_order=prim_order)
    return out
