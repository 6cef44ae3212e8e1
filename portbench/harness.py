"""One run of one cell: set-up, the measured window of frames, the check
of the window's pixels against the plain reference, and the metrics.

A cell pairs a configuration (``configs/<config>.json`` with its module
``configs/<config>.py``) with a traffic mix (``traffic/<mix>.json``); its
check limits are in ``limits/<cell>.json``; each metric is read by
``metrics/<metric>.py``.  Everything is found by the names in
``BENCHMARK.json``.

The window calls the program's ``renderer.render_frame`` frame after
frame, each with its own sampler seed drawn from ``--seed``, until the
first frame that ends after ``--seconds``.  Around the program's
integrator calls the harness sums each call's closest-hit ray counts in
int64, and in the frames to be checked (the first, and more drawn from
the seed) it keeps every sample's radiance and ray count at pixels drawn
from the seed, and the film's value there.  Once the window has closed
and the program's state is freed, the reference renders the same
samples, and ``correct`` is decided from the share that differ.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import inspect
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch


PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
WORK_DIR = os.path.join(ROOT, "build", "portbench")

# A sample (or a film value) differs where a channel is off by more than
# ATOL + RTOL |ref|, or its closest-hit ray count differs.
ATOL = 1e-3
RTOL = 1e-3
# The window's exact ray count against the program's own float32 sum.
COUNT_GAP_LIMIT = 1e-5
# The program's integrator entries as the renderer calls them (the fused
# dense wave, the integrators' Path and Whitted): each returns a call's
# per-lane radiance and closest-hit ray count.  The window's exact count
# is checked against the program's own, so a call these miss stops a run.
ENTRIES = (("yuki_tpu_torch.ops.path_fused", "path_li_wave"),
           ("yuki_tpu_torch.renderer", "path_li"),
           ("yuki_tpu_torch.renderer", "whitted_li"))
LANE_ARGS = ("px", "py", "sample_index", "seed")


@dataclass
class Cell:
    name: str
    config_name: str
    cfg: dict
    traffic: dict
    limits: dict
    module: object
    chips: int = 1


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def make_cell(name: str, config: str, traffic: str, chips: int = 1) -> Cell:
    """The cell ``name`` pairing ``configs/<config>`` with
    ``traffic/<traffic>.json``, its limits ``limits/<name>.json``."""
    return Cell(
        name=name, config_name=config,
        cfg=_read_json(os.path.join(PKG, "configs", config + ".json")),
        traffic=_read_json(os.path.join(PKG, "traffic", traffic + ".json")),
        limits=_read_json(os.path.join(PKG, "limits", name + ".json")),
        module=importlib.import_module(f"{__package__}.configs.{config}"),
        chips=chips)


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell of BENCHMARK.json's ``workloads`` named ``name``."""
    bench = load_benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    if conf["file"] != f"portbench/configs/{entry['config']}.json":
        raise ValueError(f"configuration {conf['name']!r}: file {conf['file']}")
    return make_cell(name, entry["config"], entry["traffic"],
                     int(entry["chips"]))


def metric_reader(name: str):
    return importlib.import_module(f"{__package__}.metrics.{name}").read


def frame_seed(seed: int, k: int) -> int:
    """The sampler seed of frame k (k = -1: the warm-up frame)."""
    ss = np.random.SeedSequence(entropy=[seed % (1 << 64), k + 1])
    return int(ss.generate_state(1, np.uint32)[0])


def sample_pixels(seed: int, res, tile_dim: int, n: int):
    """n distinct pixels drawn from the seed, outside the first tile (a
    padded wave renders the first tile's pixels a second time)."""
    w, h = res
    rng = np.random.default_rng([seed % (1 << 64), 7])
    flat = np.arange(w * h, dtype=np.int64)
    x, y = flat % w, flat // w
    pool = flat[(x >= tile_dim) | (y >= tile_dim)]
    pick = np.sort(rng.choice(pool, size=min(n, pool.size), replace=False))
    return pick % w, pick // w


# --- the program side ------------------------------------------------------


class Recorder:
    """Kept around the program's integrator entries (``ENTRIES``): each
    call's closest-hit ray count, summed exactly in int64 on the device;
    and, in a frame that is to be checked (``capture``), each call's
    radiance and ray count at the sampled pixels, with the call's sample
    index and seed.  A call's lanes are found by the entry's argument
    names (``px``, ``py``, ``sample_index``, ``seed``, or a ``ctx`` that
    holds them), never by position; a checked call that carries one
    sampled pixel in two lanes stops the run."""

    def __init__(self, device, w_pad: int, h_pad: int, px, py):
        self.w = w_pad
        self.lane_of = torch.full((w_pad * h_pad,), -1, dtype=torch.int32,
                                  device=device)
        self.hits = torch.zeros(w_pad * h_pad, dtype=torch.int32,
                                device=device)
        self.sflat = (torch.as_tensor(py, device=device) * w_pad
                      + torch.as_tensor(px, device=device))
        self.capture = False
        self.calls = 0
        self.lanes = 0
        self.totals = []
        self.frame = []
        self.dups = []
        self._iota = self._minus = self._ones = torch.zeros(
            0, dtype=torch.int32, device=device)
        self._saved = []

    def add(self, px, py, rc, li, sample_index, seed):
        n = int(px.shape[0])
        with torch.profiler.record_function("portbench.instrument"):
            self.totals.append(rc.sum(dtype=torch.int64))
            if self.capture:
                if self._iota.numel() < n:
                    dev = self.lane_of.device
                    self._iota = torch.arange(n, dtype=torch.int32, device=dev)
                    self._minus = torch.full((n,), -1, dtype=torch.int32,
                                             device=dev)
                    self._ones = torch.ones(n, dtype=torch.int32, device=dev)
                flat = py.to(torch.int64) * self.w + px.to(torch.int64)
                self.hits.index_add_(0, flat, self._ones[:n])
                self.dups.append((self.hits[self.sflat] > 1).any())
                self.hits.index_fill_(0, flat, 0)
                self.lane_of.scatter_(0, flat, self._iota[:n])
                lanes = self.lane_of[self.sflat]
                self.lane_of.scatter_(0, flat, self._minus[:n])
                lane = torch.clamp(lanes, min=0).to(torch.int64)
                self.frame.append((lanes >= 0, li[lane].to(torch.float32),
                                   rc[lane].to(torch.int64), int(sample_index),
                                   int(seed)))
        self.calls += 1
        self.lanes += n

    def take_frame(self):
        """(the frame's exact ray count as a device scalar, its captured
        calls), and a fresh start for the next frame."""
        dev = self.lane_of.device
        if self.dups and bool(torch.stack(self.dups).any()):
            raise RuntimeError(
                "an integrator call carried one sampled pixel in more than "
                "one lane: the recorder cannot tell its samples apart")
        total = (torch.stack(self.totals).sum() if self.totals
                 else torch.zeros((), dtype=torch.int64, device=dev))
        calls, self.totals, self.frame, self.dups = self.frame, [], [], []
        return total, calls

    def _recorded(self, fn):
        sig = inspect.signature(fn)

        def call(*args, **kw):
            res = fn(*args, **kw)
            a = sig.bind(*args, **kw).arguments
            lanes = a["ctx"] if "ctx" in a else SimpleNamespace(**a)
            if not all(hasattr(lanes, k) for k in LANE_ARGS):
                raise TypeError(f"{fn.__qualname__}{sig}: no {LANE_ARGS} "
                                "among its arguments or its ctx")
            li, rc = (res.li, res.ray_count) if hasattr(res, "li") else res
            self.add(lanes.px, lanes.py, rc, li, lanes.sample_index,
                     lanes.seed)
            return res
        return call

    def install(self):
        for mod_name, name in ENTRIES:
            mod = importlib.import_module(mod_name)
            old = getattr(mod, name)
            self._saved.append((mod, name, old))
            setattr(mod, name, self._recorded(old))

    def restore(self):
        for mod, name, old in reversed(self._saved):
            setattr(mod, name, old)
        self._saved = []


def program_objects(traffic: dict):
    from yuki_tpu_torch.integrators import PathParams, WhittedParams
    from yuki_tpu_torch.sampling import StratifiedSampler, UniformSampler

    n = traffic["pixel_samples"]
    sampler = (UniformSampler(int(n[0])) if traffic["sampler"] == "uniform"
               else StratifiedSampler(int(n[0]), int(n[1])))
    depth = int(traffic["max_depth"])
    integ = (PathParams(max_depth=depth) if traffic["integrator"] == "path"
             else WhittedParams(max_depth=depth))
    return sampler, integ


def reference_objects(traffic: dict, dtype):
    from .reference.integrate import Integrator
    from .reference.rmath import Sampler

    n = traffic["pixel_samples"]
    sampler = Sampler(traffic["sampler"], int(n[0]),
                      int(n[1]) if len(n) > 1 else 1, dtype)
    return sampler, Integrator(traffic["integrator"], int(traffic["max_depth"]))


def own_kernel_names(root: str = ROOT) -> set:
    """The ``__global__`` functions of the program's CUDA sources."""
    import re

    csrc = os.path.join(root, "yuki_tpu_torch", "ops", "csrc")
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                     r"(\w+)\s*\(", re.S)
    names = set()
    for fn in sorted(os.listdir(csrc)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, fn)) as f:
                names.update(pat.findall(f.read()))
    return names


def process_age() -> float:
    """Seconds since this process started (Linux /proc clock)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


@dataclass
class Window:
    frames_ms: list = field(default_factory=list)
    window_s: float = 0.0
    rays: int = 0  # closest-hit rays of the window's frames
    all_rays: int = 0  # and of the traced frames after it
    program_rays: int = 0  # the program's own count of all of them
    n_frames: int = 0
    traced_frames: int = 0
    traced_rays: int = 0
    traced_lanes: int = 0
    traced_launches: int = 0
    counts: dict = field(default_factory=dict)
    trace: object = None  # trace.TraceSummary of the traced frames


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def summarize_profile(prof, log):
    """The stopped profiler's trace, exported into the temporary directory,
    read (trace.TraceSummary) and deleted."""
    from .trace import summarize

    path = os.path.join(tempfile.gettempdir(), "portbench_trace.json")
    try:
        prof.export_chrome_trace(path)
        log(f"trace: {os.path.getsize(path)} bytes written")
        with open(path) as f:
            out = summarize(json.load(f))
        log(f"trace: {out.frames} frames, busy {out.busy_s:.4f} s of "
            f"{out.window_s:.4f} s")
        return out
    finally:
        if os.path.exists(path):
            os.unlink(path)


def check_schedule(seed: int, first_frame_s: float, seconds: float,
                   k: int) -> set:
    """The frames to check: the window's first, and k - 1 more drawn from
    the seed over the frames the window is expected to hold (nine tenths
    of its length over the first frame's time)."""
    n_est = int(0.9 * seconds / max(first_frame_s, 1e-6))
    rng = np.random.default_rng([seed % (1 << 64), 11])
    pool = np.arange(1, max(n_est, 1))
    pick = rng.choice(pool, size=min(k - 1, pool.size), replace=False) \
        if pool.size and k > 1 else []
    return {0} | {int(i) for i in pick}


def run_window(cell: Cell, scene, cam, film_settings, sampler, integ,
               rec: Recorder, seed: int, seconds: float, trace: bool, px, py,
               device, log, min_frames: int = 1):
    """The measured window; returns (Window, records).  A record holds a
    checked frame's sampled film values and its integrator calls as the
    Recorder kept them (``check_schedule`` picks the frames).  With
    ``trace`` the profiler records ``trace_frames`` more frames (and at
    least ``trace_seconds``) once the window has closed, so that no frame
    of the window runs after the profiler has been on."""
    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.renderer import render_frame

    tr = cell.traffic
    kw = dict(wave_tiles=int(cell.cfg["wave_tiles"]),
              samples_per_launch=int(tr["samples_per_launch"]))
    pxd = torch.as_tensor(px, device=device)
    pyd = torch.as_tensor(py, device=device)
    win = Window()
    totals, prog, records = [], [], []
    n_check = int(tr["check_frames"])
    schedule = {0}
    trace_frames = int(tr.get("trace_frames", 2))
    trace_seconds = float(tr.get("trace_seconds", 1.0))
    prof = None
    traced_s = 0.0
    t_start = time.perf_counter()
    k = 0
    while True:
        tracing = prof is not None
        rng_ctx = (torch.profiler.record_function("portbench.frame") if tracing
                   else contextlib.nullcontext())
        rec.capture = k in schedule or (min_frames > 1 and k < min_frames)
        t0 = time.perf_counter()
        with rng_ctx:
            fr = render_frame(scene, cam, film_settings, sampler, integ,
                              seed=frame_seed(seed, k), **kw)
            _sync(device)
        t1 = time.perf_counter()
        prog.append(int(fr.ray_count))
        total, calls = rec.take_frame()
        totals.append(total)
        if rec.capture:
            with torch.profiler.record_function("portbench.instrument"):
                film = fr.film.image_device()[pyd, pxd]
            records.append(dict(index=k, film=film, calls=calls))
        del fr
        if k == 0:
            schedule = check_schedule(seed, t1 - t0, seconds, n_check)
        k += 1
        if not tracing:
            win.frames_ms.append((t1 - t0) * 1e3)
            if t1 - t_start < seconds or k < min_frames:
                continue
            win.window_s = t1 - t_start
            win.n_frames = k
            win.rays = int(torch.stack(totals).sum())
            if not trace:
                break
            traverse.reset_counts()
            calls0, lanes0, rays0 = rec.calls, rec.lanes, len(totals)
            prof = _profile(device)
            prof.__enter__()
            continue
        traced_s += t1 - t0
        win.traced_frames += 1
        if win.traced_frames >= trace_frames and traced_s >= trace_seconds:
            _sync(device)
            prof.__exit__(None, None, None)
            win.counts = dict(traverse.counts())
            win.traced_launches = rec.calls - calls0
            win.traced_lanes = rec.lanes - lanes0
            win.traced_rays = int(torch.stack(totals[rays0:]).sum())
            win.trace = summarize_profile(prof, log)
            prof = None
            break
    win.all_rays = int(torch.stack(totals).sum())
    win.program_rays = sum(prog)
    ms = sorted(win.frames_ms)
    log(f"window: {win.n_frames} frames in {win.window_s:.3f} s, {win.rays} "
        f"rays; frame ms median {ms[len(ms) // 2]:.1f}, max {ms[-1]:.1f}; "
        f"checked frames {[r['index'] for r in records]}; "
        f"{win.traced_frames} traced after it")
    return win, records


# --- the check ----------------------------------------------------------------


def _differs(got_v, got_c, ref_v, ref_c):
    ref_v = ref_v.to(torch.float32)
    bad = (torch.abs(got_v - ref_v) > ATOL + RTOL * torch.abs(ref_v)).any(dim=-1)
    return bad | (got_c != ref_c) | ~torch.isfinite(got_v).all(dim=-1)


def _to(record, device):
    return dict(index=record["index"], film=record["film"].to(device),
                calls=[tuple(x.to(device) if torch.is_tensor(x) else x
                             for x in c) for c in record["calls"]])


@dataclass
class Check:
    samples: int = 0
    bad_samples: int = 0
    clean_pixels: int = 0
    bad_pixels: int = 0
    frames: list = field(default_factory=list)

    def share(self) -> float:
        """Differing samples and film values over all compared."""
        n = self.samples + self.clean_pixels
        return (self.bad_samples + self.bad_pixels) / n if n else 1.0


def check_frames_against(cell: Cell, records, px, py, device, dtype,
                         ref) -> Check:
    """Every kept sample of the checked frames against the reference's
    rendering of the same pixel, sample index and seed; and each pixel
    whose samples all agree, its film value against the reference's mean
    of its samples.  ``ref``: the reference's (scene, camera) in
    ``dtype``."""
    from .reference.integrate import pixel_mean, render_samples
    from .reference.rmath import camera_matrices

    sc, cam = ref
    c2w, r2c = camera_matrices(cam, *cell.cfg["res"])
    sampler, integ = reference_objects(cell.traffic, dtype)
    spp = sampler.spp
    pxd = torch.as_tensor(px, device=device)
    pyd = torch.as_tensor(py, device=device)
    n_pix = pxd.shape[0]
    out = Check()
    for record in records:
        record = _to(record, device)
        out.frames.append(record["index"])
        ref_li = {}
        ok_all = torch.ones(n_pix, dtype=torch.bool, device=device)
        seen = torch.zeros(n_pix, dtype=torch.int64, device=device)
        for ok, li, rc, s, seed in record["calls"]:
            idx = torch.nonzero(ok)[:, 0]
            if idx.numel() == 0:
                continue
            rv, rr = render_samples(sc, c2w, r2c, sampler, integ, pxd[idx],
                                    pyd[idx], s, seed)
            bad = _differs(li[idx], rc[idx], rv, rr)
            out.samples += int(idx.numel())
            out.bad_samples += int(bad.sum())
            ok_all[idx[bad]] = False
            seen[idx] += 1
            full = ref_li.setdefault(s, torch.zeros((n_pix, 3), dtype=rv.dtype,
                                                   device=device))
            full[idx] = rv
        clean = ok_all & (seen == spp)
        if spp and len(ref_li) == spp:
            mean = pixel_mean([ref_li[s] for s in sorted(ref_li)], spp)
            zero = torch.zeros(n_pix, dtype=torch.int64, device=device)
            bad_px = _differs(record["film"], zero, mean, zero) & clean
            out.clean_pixels += int(clean.sum())
            out.bad_pixels += int(bad_px.sum())
    return out


# --- one run --------------------------------------------------------------------------


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             log=lambda s: print(s, file=sys.stderr), work_dir=None):
    """One run: the result dict, with the numbers compared and their
    limits under ``compared``.  ``work_dir`` (default
    ``build/portbench/<config>`` in the checkout) holds the files the
    configuration generates."""
    age0, m0 = process_age(), time.perf_counter()
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    marks = [("start", age0)]
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(("cuda", age0 + time.perf_counter() - m0))
    work_dir = work_dir or os.path.join(WORK_DIR, cell.config_name)
    os.makedirs(work_dir, exist_ok=True)
    from yuki_tpu_torch.ops import _build

    if device.type == "cuda":
        _build.library()
    marks.append(("library", age0 + time.perf_counter() - m0))
    t0 = time.perf_counter()
    scene, cam, film_settings = cell.module.program_scene(cell.cfg, device,
                                                          work_dir)
    _sync(device)
    scene_build_s = time.perf_counter() - t0
    sampler, integ = program_objects(cell.traffic)
    td = int(cell.cfg["tile_dim"])
    w, h = cell.cfg["res"]
    px, py = sample_pixels(seed, (w, h), td, int(cell.traffic["check_pixels"]))
    rec = Recorder(device, -(-w // td) * td, -(-h // td) * td, px, py)
    rec.install()
    try:
        from yuki_tpu_torch.renderer import render_frame

        kw = dict(wave_tiles=int(cell.cfg["wave_tiles"]),
                  samples_per_launch=int(cell.traffic["samples_per_launch"]))
        render_frame(scene, cam, film_settings, sampler, integ,
                     seed=frame_seed(seed, -1), **kw)
        _sync(device)
        rec.take_frame()
        marks.append(("warm frame", age0 + time.perf_counter() - m0))
        # The window starts from a collected heap, whatever set-up left.
        gc.collect()
        setup_s = age0 + (time.perf_counter() - m0)
        log(f"set-up {setup_s:.3f} s (scene {scene_build_s:.3f} s; at "
            + ", ".join(f"{k} {v:.3f}" for k, v in marks) + ")")
        win, records = run_window(cell, scene, cam, film_settings, sampler,
                                  integ, rec, seed, seconds, trace, px, py,
                                  device, log)
    finally:
        rec.restore()
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    records = [_to(r, torch.device("cpu")) for r in records]
    del scene, rec
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    gap = abs(win.all_rays - win.program_rays) / max(win.all_rays, 1)
    if gap > COUNT_GAP_LIMIT:
        raise RuntimeError(
            f"the harness counted {win.all_rays} closest-hit rays and the "
            f"program {win.program_rays} (gap {gap:.3g} > {COUNT_GAP_LIMIT}): "
            "the recorder no longer sees every integrator call")
    t_ref = time.perf_counter()
    ref = cell.module.reference_scene(cell.cfg, device, torch.float32,
                                      work_dir)
    chk = check_frames_against(cell, records, px, py, device, torch.float32,
                               ref)
    ref_scene = ref[0]
    log(f"reference: frames {chk.frames}: {chk.bad_samples} of {chk.samples} "
        f"samples and {chk.bad_pixels} of {chk.clean_pixels} clean pixels "
        f"differ ({time.perf_counter() - t_ref:.3f} s)")
    spp = reference_objects(cell.traffic, torch.float32)[0].spp
    expected = len(chk.frames) * px.size * spp
    compared = {
        "mismatch_share": {"value": chk.share(),
                           "limit": float(cell.limits["mismatch_share"])},
        "missing_samples": {"value": expected - chk.samples, "limit": 0},
    }
    correct = (chk.share() <= compared["mismatch_share"]["limit"]
               and chk.samples == expected and win.rays > 0)
    readings = dict(cell=cell, win=win, setup_s=setup_s,
                    scene_build_s=scene_build_s, trace=win.trace,
                    own_kernels=own_kernel_names(), scene=ref_scene)
    return dict(correct=correct, readings=readings, compared=compared,
                peak=int(peak))
