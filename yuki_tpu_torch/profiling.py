"""Profiling hooks: the port's one tracing layer (port of
``yuki_tpu/profiling.py``, :34-88, extended).

  * ``pass_scope(name)`` — the one way the port opens a span: a
    ``torch.profiler.record_function`` range named ``name``, one of
    ``SCOPES``, so that a profiler trace attributes the host's work and
    the kernels launched inside it to the span, on the profiler's clock.
    The range is entered only while a torch profiler session runs
    (``profiler_on``); otherwise ``pass_scope`` returns a shared no-op
    context, so an unprofiled frame pays one check a span.  yuki_tpu's
    scopes are ``jax.named_scope``s at the shading and wave passes'
    places under the same names.
  * ``SCOPES`` — the one registry of span names.  A range's device copy
    in a trace repeats the time of the kernels inside it, so profile
    readers (chip_smoke.py, chip_ab.py, portbench) leave these names out
    of device busy time.
  * ``host_read(x, site)`` — the one way the port reads a device value on
    the host (a sync on the card): returns ``x.item()`` and adds one to
    the counter ``host_reads.<site>``.
  * ``counts()`` / ``reset_counts()`` — the counter registry.  Counters
    are always on, updated under ``_build.bump``'s lock as the kernels'
    ``LAUNCHES`` and the dispatch's ``COUNTS`` are.
  * the collector hook — a ``gc.callbacks`` entry, installed when this
    module is imported, that opens a ``python.gc`` range at each pass of
    Python's collector and closes it when the pass ends, only while a
    profiler runs.
  * ``device_trace(dir)`` — a ``torch.profiler`` capture (CPU activity,
    and CUDA activity where a card is present) of every thread, the
    renderer's manager thread included, written as a Chrome trace into
    ``dir``; wired to the CLI's ``--profile=DIR`` flag.
"""

from __future__ import annotations

import contextlib
import gc
import logging
import os
import threading
from collections import defaultdict
from typing import Iterator

import torch
from torch.autograd import profiler as _autograd_profiler

from .ops import _build

_log = logging.getLogger("yuki")

TRACE_FILE = "trace.json"


# Every pass_scope range: the shading and wave passes, then the renderer's
# wave loop, the stratified sampler, Whitted's tree steps, the collector's
# passes and the treelet dispatch's stages.
SCOPES = ("trace.closest", "shade.fused", "trace.occlusion",
          "shade.resolve", "path_fused.wave1k", "path_fused.raygen_trace",
          "path_fused.bounces", "shade.surface", "shade.nee",
          "shade.bsdf_sample",
          "renderer.frame_setup", "renderer.wave_prep", "renderer.launch",
          "renderer.read_rays", "renderer.film_add", "renderer.report",
          "sampling.stratified", "whitted.step", "python.gc",
          "traverse.sort", "traverse.probe", "traverse.cull",
          "traverse.layout", "traverse.walk", "traverse.merge",
          "traverse.wide", "traverse.fallback", "traverse.bary")

_OFF = contextlib.nullcontext()

# host_reads.<site>: reads of device values on the host since
# reset_counts().
COUNTS: dict = defaultdict(int)


def profiler_on() -> bool:
    """Whether a torch profiler session runs.  ``torch.profiler.profile``
    sets the autograd profiler's module flag in every thread, also with
    ``profile_all_threads`` (where ``_profiler_enabled()``, a per-thread
    state, reads False); the legacy profilers set only the latter."""
    return (_autograd_profiler._is_profiler_enabled
            or torch.autograd._profiler_enabled())


def pass_scope(name: str):
    """A span named ``name`` (one of SCOPES) while a profiler runs; a
    shared no-op context otherwise."""
    if name not in SCOPES:
        raise ValueError(f"pass_scope {name!r} is not in profiling.SCOPES")
    if not profiler_on():
        return _OFF
    return torch.profiler.record_function(name)


def host_read(x: torch.Tensor, site: str):
    """``x.item()``, counted in ``host_reads.<site>``."""
    _build.bump(COUNTS, "host_reads." + site)
    return x.item()


def counts() -> dict:
    """The counters since reset_counts()."""
    return dict(COUNTS)


def reset_counts() -> None:
    COUNTS.clear()


_gc_spans = threading.local()


def _gc_span(phase: str, info: dict) -> None:
    """``gc.callbacks`` entry: a python.gc range around each collector
    pass that starts while a profiler runs."""
    if phase == "start":
        if profiler_on():
            span = pass_scope("python.gc")
            span.__enter__()
            _gc_spans.open = span
    else:
        span = getattr(_gc_spans, "open", None)
        if span is not None:
            _gc_spans.open = None
            span.__exit__(None, None, None)


gc.callbacks.append(_gc_span)


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
