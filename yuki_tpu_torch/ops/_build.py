"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles each ``csrc/*.cu`` source into an object, all of them
at once in parallel processes, and links the objects into one shared
library with a plain C interface, loaded through ``ctypes`` (no PyTorch
headers, so the build takes seconds):

  path_fused.cu      the dense wave: raygen_trace, bounce, the one-kernel wave
  shade_fused.cu     the treelet path's shade and resolve kernels
  trace_treelets.cu  the two-level treelet walks (closest, any)
  trace_stream.cu    the crossing words and the slot walks (closest, any)
  trace_cull.cu      the two-level cull
  trace_rows.cu      the row-union walks of coherent waves (closest, any)
  trace_dense.cu     the dense scenes' trace sweeps (closest, any)
  trace_walker.cu    the bundle walks of divergent waves (closest, any)
  trace_pairs.cu     the block-pair treelet walks (closest, any)
  sampling.cu        the stratified sampler's draws, a list of them a launch
  whitted_fused.cu   Whitted's tree step around the trace queries: shade,
                     resolve

``path_fused.cuh`` holds the device maths they share, ``trace_stream.cuh``
the slab and scaled watertight tests of the stream, cull, row and walker
kernels and the framed chunk copies (and their closest walk) of the
stream, row and dense kernels, ``trace_treelets.cuh`` the lanes, box test
and row staging of the treelet and pair walks.  The library lands
in ``build/yuki_tpu_torch/`` at the repository root, named by a hash of
the sources and flags, so an edited source is rebuilt and an unchanged
one is reused; a file lock keeps concurrent processes from building it
twice.  ``nvcc``'s ``-Xptxas -v`` report (registers, spills) is kept
beside it as ``ptxas_<hash>.txt``.

Nothing here runs at import time: the CPU tests import every module, and
this machine class has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..native import BUILD_DIR, locked_build

CSRC = Path(__file__).resolve().parent / "csrc"
UNITS = ("path_fused.cu", "shade_fused.cu", "trace_treelets.cu",
         "trace_stream.cu", "trace_cull.cu", "trace_rows.cu", "trace_dense.cu",
         "trace_walker.cu", "trace_pairs.cu", "sampling.cu",
         "whitted_fused.cu")
SOURCES = UNITS + ("path_fused.cuh", "trace_stream.cuh", "trace_treelets.cuh")

# -fmad=false: contracting a*b - c*d into an FMA changes the watertight
# test's edge functions (ARCHITECTURE.md, "FMA hazard" in ROADMAP.md).
# No --use_fast_math: divisions and square roots stay IEEE.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None
ptxas_report = ""  # -Xptxas -v output of the build that made the library


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    # device, px, py, n, sample_index, seed, ms, tri, n_tris, trs, sp,
    # n_spheres, spl, st, ph, stream
    lib.yk_raygen_trace.argtypes = [i, p, p, i, u, u, p, p, i, p, p, i, p, p,
                                    p, p]
    lib.yk_bounce.argtypes = [
        i, p, p, p, i, i, i, i,  # device, st_in, ph, st_out, n, dim0, bounce, max_depth
        p, p, i, p, p, p, i,  # ms, tri, n_tris, trs, mat, lt, n_lights
        p, i, p, i, p, i, i,  # sp, n_spheres, td, n_td, tex, pool_pad, flags
        p, p,  # spl, stream
    ]
    lib.yk_wave.argtypes = [
        i, p, p, i, u, u, i,  # device, px, py, n, sample_index, seed, max_depth
        p, p, i, p, p, p, i,  # ms, tri, n_tris, trs, mat, lt, n_lights
        p, i, p, i, p, i, i,  # sp, n_spheres, td, n_td, tex, pool_pad, flags
        p, p, p,  # spl, out, stream
    ]
    lib.yk_shade.argtypes = [
        i, p, p, p, p, i, i, i,  # device, rh, prim, ph, texp, n, dim0, bounce
        p, p, p, i, p, i,  # trs, mat, lt, n_lights, sp, n_spheres
        f, f, f, f, i, p, p, p,  # centre xyz, diag, flags, spl, out, stream
    ]
    lib.yk_resolve.argtypes = [i, p, p, i, i, i, i, p, p]
    lib.yk_treelet_votes.argtypes = [
        i, p, p, p, i,  # device, sb, sr, tb, n_supers
        p, p, p, i, p, p,  # o, d, tmax, n, votes, stream
    ]
    lib.yk_treelet_closest.argtypes = [
        i, p, p, p, p, i, i, p,  # device, sb, sr, tb, rows, n_supers, leaf_size, order
        p, p, p, i, p, p, p, p, p,  # o, d, tmax, n, t, prim, b0, b1, stream
    ]
    lib.yk_treelet_any.argtypes = [
        i, p, p, p, p, i, i,  # device, sb, sr, tb, rows, n_supers, leaf_size
        p, p, p, p, i, p, p,  # o, d, tmax, skip, n, occ, stream
    ]
    lib.yk_cross_words.argtypes = [
        i, p, p, i,  # device, word boxes [6, W], chunk boxes [6, 32 W], W
        p, p, p, i, p, p,  # o, d, tmax, n, words, stream
    ]
    lib.yk_cull.argtypes = [
        i, p, i, p, i, i, i,  # device, word boxes, n_words, chunk boxes, n_chunks, S, C
        p, p, p, i, p, p, p,  # o, d, tmax, n, lists, overflow, stream
    ]
    # device, rows, leaf_size, row_chunk, n_rows, ray stream, with_skip,
    # out, stream
    lib.yk_slot_closest.argtypes = [i, p, i, p, i, p, i, p, p]
    # device, rows, leaf_size, row_chunk, n_rows, ray stream, occ, stream
    lib.yk_slot_any.argtypes = [i, p, i, p, i, p, p, p]
    lib.yk_rows_closest.argtypes = [
        i, p, p, i, p, i, i,  # device, chunk boxes, rows, leaf_size, lists, C, n_rows
        p, p, p, p, p, p,  # o, d, tmax, skip (or null), out, stream
    ]
    lib.yk_rows_any.argtypes = [
        i, p, p, i, p, i, i,  # device, chunk boxes, rows, leaf_size, lists, C, n_rows
        p, p, p, p, p, p,  # o, d, tmax, skip, occ, stream
    ]
    lib.yk_dense_closest.argtypes = [
        i, p, p, i, p, p, p, p, i,  # device, tris, light, n_tris, o, d, tmax, skip, n
        p, p, p, p, p,  # t, prim, b0, b1, stream
    ]
    # device, chunk boxes, rows, rows to each chunk's last real row,
    # leaf_size, lists, C, n_bundles, o, d, tmax, skip (or null), t, prim,
    # stream; the occlusion walk: skip, occ, stream
    lib.yk_walker_closest.argtypes = [i, p, p, p, i, p, i, i, p, p, p, p, p,
                                      p, p]
    lib.yk_walker_any.argtypes = [i, p, p, p, i, p, i, i, p, p, p, p, p, p]
    for name in ("yk_pairs_closest", "yk_pairs_any"):
        # device, treelet boxes, rows, leaf_size, runs, pair treelets,
        # block order, n_blocks, packed rays, n, then t + prim + b0 + b1
        # (closest) or occ (any), stream
        getattr(lib, name).argtypes = [i, p, p, i, p, p, p, i, p, i] + [p] * (
            5 if name == "yk_pairs_closest" else 2)
    lib.yk_dense_any.argtypes = [
        i, p, p, i, p, p, p, p, i,  # device, tris, light, n_tris, o, d, tmax, skip, n
        p, p,  # occ, stream
    ]
    lib.yk_strat_draws.argtypes = [
        i, p, p, i, u, u,  # device, px, py, n, sample_index, seed
        i, i, i, p, i,  # pixel_samples_x, _y, jitter, draw codes, n_draws
        p, p,  # out, stream
    ]
    # device, a WhittedArgs (ops/whitted_fused._Args) by pointer, stream
    lib.yk_whitted_shade.argtypes = [i, p, p]
    lib.yk_whitted_resolve.argtypes = [i, p, p]
    for name in ("yk_raygen_trace", "yk_bounce", "yk_shade", "yk_resolve",
                 "yk_treelet_votes", "yk_treelet_closest", "yk_treelet_any",
                 "yk_cross_words",
                 "yk_cull", "yk_slot_closest", "yk_slot_any",
                 "yk_rows_closest", "yk_rows_any", "yk_dense_closest",
                 "yk_dense_any", "yk_walker_closest", "yk_walker_any",
                 "yk_wave", "yk_pairs_closest", "yk_pairs_any",
                 "yk_strat_draws", "yk_whitted_shade", "yk_whitted_resolve"):
        getattr(lib, name).restype = i
    lib.yk_error_string.argtypes = [i]
    lib.yk_error_string.restype = ctypes.c_char_p


def _compile(tmp: str, report: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    nvcc = _nvcc()
    objs = [f"{tmp}.{unit}.o" for unit in UNITS]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / unit)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for unit, obj in zip(UNITS, objs)
    ]
    try:
        logs = [proc.communicate()[0] for proc in procs]
        failed = [(unit, proc.returncode, log) for unit, proc, log
                  in zip(UNITS, procs, logs) if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{unit} ({rc}):\n{log}" for unit, rc, log in failed))
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", tmp, *objs],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({link.returncode}):\n{link.stdout}\n"
                f"{link.stderr}")
        report.write_text("".join(logs))
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.unlink(obj)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed.  Raises if the
    build or the load fails; there is no fallback."""
    global _lib, ptxas_report
    with _lock:
        if _lib is not None:
            return _lib
        tag = _digest()
        so = BUILD_DIR / f"libyuki_kernels_{tag}.so"
        report = BUILD_DIR / f"ptxas_{tag}.txt"
        locked_build(so, lambda tmp: _compile(tmp, report))
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        ptxas_report = report.read_text() if report.exists() else ""
        _lib = lib
        return lib


def error_string(err: int) -> str:
    if _lib is None:
        return f"CUDA error {err}"
    return f"CUDA error {err}: {_lib.yk_error_string(err).decode()}"


# ---- helpers shared by the kernel wrappers --------------------------------


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(dev) -> ctypes.c_void_p:
    """PyTorch's current stream on ``dev``, for the launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def check(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` has the device, dtype, shape and contiguity a
    kernel takes."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_aligned(t, name: str) -> None:
    """Raise unless ``t``'s data starts on a 16-byte boundary: a kernel
    reads it in 16-byte loads."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def dispatch(t) -> bool:
    """True: launch the kernel (CUDA tensor).  False: plain version (CPU
    tensor).  Anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel or plain version for device {t.device}")


def bump(counts: dict, key: str, n: int = 1) -> None:
    """Add ``n`` to ``counts[key]`` under a lock: the launch and dispatch
    counters are module-level dicts that the viewer's request threads and
    the renderer's manager thread update at once."""
    with _count_lock:
        counts[key] += n


def launch_check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {error_string(err)}")
