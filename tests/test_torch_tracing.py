"""The port's tracing layer (``yuki_tpu_torch.profiling``): spans only
while a profiler runs, every span of the wave loop, the stratified
sampler, Whitted's steps and the collector where it applies, properly
nested, on the rendering thread and on the Renderer's manager thread; and
the host-read counters against the reads the code makes.  No JAX."""

from __future__ import annotations

import gc
import json
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from yuki_tpu_torch import integrators, profiling, renderer, traverse
from yuki_tpu_torch.film import FilmSettings, film_or_new
from yuki_tpu_torch.integrators import PathParams, WhittedParams
from yuki_tpu_torch.renderer import (RenderError, RenderFinished, Renderer,
                                     RenderSettings, render_frame)
from yuki_tpu_torch.sampling import StratifiedSampler

FS = FilmSettings(res=(64, 64), tile_dim=16)
WAVE_TILES = 8  # 16 tiles: two waves
WAVES = 2
DEPTH = 5
RENDERER_SPANS = {"renderer.frame_setup", "renderer.wave_prep",
                  "renderer.launch", "renderer.read_rays",
                  "renderer.film_add", "renderer.report"}
CASES = {
    "path": (StratifiedSampler(2, 2), PathParams(DEPTH),
             {"sampling.stratified", "path_fused.raygen_trace",
              "path_fused.bounces"}),
    "whitted": (StratifiedSampler(1, 1), WhittedParams(3),
                {"sampling.stratified", "whitted.step", "trace.closest",
                 "shade.surface", "shade.nee", "trace.occlusion"}),
}


@pytest.fixture(scope="module")
def scene_and_cam():
    from yuki_tpu_torch.scene.cornell import cornell

    scene, cam, _ = cornell(device="cpu")
    return scene, cam


def _frame(scene_and_cam, case):
    sampler, integ, _ = CASES[case]
    scene, cam = scene_and_cam
    return render_frame(scene, cam, FS, sampler, integ,
                        wave_tiles=WAVE_TILES, samples_per_launch=4, seed=3)


def _ranges(trace_events, tid=None):
    """[(start, end, name)] of the trace's record_function ranges, on
    ``tid`` if given, sorted by start and then longest first."""
    out = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
            e["tid"]) for e in trace_events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and (tid is None or e["tid"] == tid)]
    return sorted(out, key=lambda r: (r[0], -r[1]))


def _parents(ranges):
    """Each range's innermost enclosing range's name (None at the top),
    checking that ranges on one thread nest: none straddles another."""
    out, stack = [], []
    for s, e, name, tid in ranges:
        while stack and stack[-1][1] <= s:
            stack.pop()
        if stack:
            assert e <= stack[-1][1], (name, "straddles", stack[-1][2])
        out.append((name, stack[-1][2] if stack else None))
        stack.append((s, e, name))
    return out


def _trace_of(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def test_no_profiler_no_ranges(scene_and_cam, monkeypatch):
    """Without a profiler no span enters record_function: a Path frame
    with the stratified sampler, a Whitted frame and a collection."""
    assert not profiling.profiler_on()

    def refuse(*args, **kw):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for case in CASES:
        assert _frame(scene_and_cam, case).ray_count > 0
    gc.collect()
    assert profiling.pass_scope("renderer.launch") is profiling._OFF


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_nest_and_outputs_hold(scene_and_cam, case, tmp_path,
                                     monkeypatch):
    """Under torch.profiler every span that applies is emitted once per
    place, nested where the work is, a collection inside the frame gives
    a python.gc range, and the film and ray count are the untraced
    frame's bit for bit."""
    plain = _frame(scene_and_cam, case)
    make = renderer.make_wave_renderer

    def collecting(*args, **kw):
        gc.collect()
        return make(*args, **kw)

    monkeypatch.setattr(renderer, "make_wave_renderer", collecting)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _frame(scene_and_cam, case)
    assert torch.equal(traced.film.tiles_buf, plain.film.tiles_buf)
    assert torch.equal(traced.film.samples, plain.film.samples)
    assert traced.ray_count == plain.ray_count
    events = _trace_of(prof, tmp_path)
    tid = next(e["tid"] for e in events if e.get("name") == "renderer.launch")
    parents = _parents(_ranges(events, tid))
    names = {n for n, _ in parents}
    assert names >= RENDERER_SPANS | CASES[case][2] | {"python.gc"}
    assert names <= set(profiling.SCOPES)
    by = {}
    for name, parent in parents:
        by.setdefault(name, set()).add(parent)
    for name in RENDERER_SPANS:
        assert by[name] == {None}, (name, by[name])
    assert "renderer.frame_setup" in by["python.gc"]
    count = {n: sum(1 for m, _ in parents if m == n) for n in names}
    assert count["renderer.frame_setup"] == 2  # the film; the rest
    for name in ("renderer.wave_prep", "renderer.read_rays",
                 "renderer.film_add", "renderer.report"):
        assert count[name] == WAVES
    assert count["renderer.launch"] == WAVES  # 4 spp, 4 a launch
    if case == "path":
        assert by["sampling.stratified"] == {"renderer.launch"}
        assert by["path_fused.bounces"] == {"renderer.launch"}
    else:
        assert by["whitted.step"] == {"renderer.launch"}
        assert by["sampling.stratified"] == {"renderer.launch", "shade.nee"}
        for name in ("trace.closest", "shade.surface", "shade.nee"):
            assert by[name] == {"whitted.step"}, (name, by[name])


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_reads_by_site(scene_and_cam, case):
    """host_reads.<site> counts the reads the code makes: one a wave for
    the ray count; one a stratified draw (power-of-two strata accept in
    the first round); one a Whitted step check, which is also the one
    read the dispatch's host_syncs counted before the counter existed."""
    traverse.reset_counts()
    integrators.reset_counts()
    _frame(scene_and_cam, case)
    c = traverse.counts()
    calls = WAVES * CASES[case][0].samples_per_pixel  # integrator calls
    reads = {k: v for k, v in c.items() if k.startswith("host_reads.")}
    if case == "path":
        # 1 + depth (L + 2) draws a call: the jitter; per bounce a light,
        # the BSDF sample, roulette.
        assert reads == {"host_reads.renderer": WAVES,
                         "host_reads.sampling": calls * (1 + DEPTH * 3)}
        assert c["host_syncs"] == 0
    else:
        steps = integrators.COUNTS["whitted_steps"]
        assert steps > calls
        assert reads["host_reads.renderer"] == WAVES
        assert reads["host_reads.sampling"] == calls + steps  # one light
        # Each call checks before every step and once more to end, unless
        # it used up the step budget (7 at depth 3 with glass).
        assert steps + calls >= reads["host_reads.whitted"] >= steps
        assert c["host_syncs"] == reads["host_reads.whitted"]
        assert set(reads) == {"host_reads.renderer", "host_reads.sampling",
                              "host_reads.whitted"}
    profiling.reset_counts()
    assert profiling.counts() == {}


def test_host_read_counts_and_returns():
    profiling.reset_counts()
    x = torch.tensor([7], dtype=torch.int64)
    assert profiling.host_read(x[0], "renderer") == 7
    assert profiling.host_read(x[0] > 3, "sampling") is True
    assert profiling.counts() == {"host_reads.renderer": 1,
                                  "host_reads.sampling": 1}
    profiling.reset_counts()


def test_renderer_thread_spans_under_device_trace(scene_and_cam, tmp_path):
    """The CLI's --profile capture (device_trace, every thread): the
    manager thread's wave loop emits its spans on its own thread."""
    scene, cam = scene_and_cam
    sampler, integ, inner = CASES["path"]
    film = film_or_new(None, FS, device="cpu")
    r = Renderer()
    with profiling.device_trace(str(tmp_path)):
        r.launch(scene, cam, film, sampler, integ, FS,
                 RenderSettings(wave_tiles=WAVE_TILES), match_seed=3)
        t0, done = time.monotonic(), None
        while done is None and time.monotonic() - t0 < 120.0:
            time.sleep(0.05)
            done = next((m for m in r.check_status()
                         if isinstance(m, (RenderFinished, RenderError))),
                        None)
        r.kill()
    assert isinstance(done, RenderFinished), done
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())[
        "traceEvents"]
    ranges = _ranges(events)
    tids = {tid for _, _, name, tid in ranges if name == "renderer.launch"}
    assert len(tids) == 1
    parents = _parents([r for r in ranges if r[3] in tids])
    assert tids != {threading.get_native_id()}
    assert {n for n, _ in parents} >= RENDERER_SPANS | inner
