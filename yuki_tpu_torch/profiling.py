"""Profiling hooks: port of ``yuki_tpu/profiling.py`` (:34-88).

  * ``pass_scope(name)`` — ``torch.profiler.record_function``: a named
    range around a render pass, so that a profiler trace attributes the
    host ops and the kernels they launch to it.  yuki_tpu's scopes are
    ``jax.named_scope``s at the same places under the same names
    (``integrators.path_li``, ``ops.path_fused.path_li_wave``).
  * ``device_trace(dir)`` — a ``torch.profiler`` capture (CPU activity,
    and CUDA activity where a card is present) of every thread, the
    renderer's manager thread included, written as a Chrome trace into
    ``dir``; wired to the CLI's ``--profile=DIR`` flag.
  * ``PassTimer`` — host-side wall-clock aggregation per named phase.

``pass_scope`` costs one record_function enter/exit a pass (a few
microseconds) and records nothing unless a profiler runs; device traces
only run when a directory is given.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Iterator

import torch

_log = logging.getLogger("yuki")

TRACE_FILE = "trace.json"


# Every pass_scope range.  A range's device span repeats the time of the
# kernels inside it, so profile readers (chip_smoke.py, chip_ab.py) leave
# these names out of device busy time.
SCOPES = ("trace.closest", "shade.fused", "trace.occlusion",
          "shade.resolve", "path_fused.wave1k", "path_fused.raygen_trace",
          "path_fused.bounces", "shade.surface", "shade.nee",
          "shade.bsdf_sample")


def pass_scope(name: str):
    """Name a render pass for the profiler; ``name`` is one of SCOPES."""
    if name not in SCOPES:
        raise ValueError(f"pass_scope {name!r} is not in profiling.SCOPES")
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def device_trace(trace_dir: str | None) -> Iterator[None]:
    """Capture a torch.profiler trace of every thread into
    ``trace_dir/trace.json`` (Chrome trace format; open it in Perfetto or
    chrome://tracing).  No-op when ``trace_dir`` is None."""
    if not trace_dir:
        yield
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    _log.info("profiler: capturing device trace to %s", trace_dir)
    with profile(activities=activities, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True))) as prof:
        yield
    path = os.path.join(trace_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    _log.info("profiler: trace written to %s", path)


class PassTimer:
    """Accumulates wall time per named phase; logs a summary on demand.

    >>> t = PassTimer()
    >>> with t.phase("bvh build"): build()
    >>> t.summary()  # 'bvh build: 1 call, 12.3 ms total'
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> str:
        lines = [
            f"{name}: {self.counts[name]} call(s), "
            f"{self.totals[name] * 1e3:.1f} ms total"
            for name in sorted(self.totals, key=self.totals.get, reverse=True)
        ]
        return "\n".join(lines)

    def log_summary(self, header: str = "pass timings"):
        if self.totals:
            _log.info("%s:\n%s", header, self.summary())
