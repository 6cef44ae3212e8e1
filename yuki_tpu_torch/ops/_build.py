"""Build and load the wave's CUDA kernels at first use.

``nvcc`` compiles ``csrc/path_fused.cu`` into a shared library with a
plain C interface, loaded through ``ctypes`` (no PyTorch headers, so the
build takes seconds).  The library lands in ``build/yuki_tpu_torch/`` at
the repository root, named by a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is reused.  ``nvcc``'s
``-Xptxas -v`` report (registers, spills) is kept beside it as
``ptxas_<hash>.txt``.

Nothing here runs at import time: the CPU tests import every module, and
this machine class has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("path_fused.cu", "path_fused.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "yuki_tpu_torch"

# -fmad=false: contracting a*b - c*d into an FMA changes the watertight
# test's edge functions (ARCHITECTURE.md, "FMA hazard" in ROADMAP.md).
# No --use_fast_math: divisions and square roots stay IEEE.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
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
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.yk_raygen_trace.argtypes = [i, p, p, i, u, u, p, p, i, p, i, p, p, p]
    lib.yk_raygen_trace.restype = i
    lib.yk_bounce.argtypes = [
        i, p, p, p, i, i, i, i,  # device, st_in, ph, st_out, n, dim0, bounce, max_depth
        p, p, i, p, p, p, i,  # ms, tri, n_tris, trs, mat, lt, n_lights
        p, i, p, i, p, i, i,  # sp, n_spheres, td, n_td, tex, pool_pad, flags
        p,  # stream
    ]
    lib.yk_bounce.restype = i
    lib.yk_error_string.argtypes = [i]
    lib.yk_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed.  Raises if the
    build or the load fails; there is no fallback."""
    global _lib, ptxas_report
    with _lock:
        if _lib is not None:
            return _lib
        tag = _digest()
        so = BUILD_DIR / f"libyuki_path_fused_{tag}.so"
        report = BUILD_DIR / f"ptxas_{tag}.txt"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / "path_fused.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
                )
            report.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        ptxas_report = report.read_text() if report.exists() else ""
        _lib = lib
        return lib


def error_string(err: int) -> str:
    if _lib is None:
        return f"CUDA error {err}"
    return f"CUDA error {err}: {_lib.yk_error_string(err).decode()}"
