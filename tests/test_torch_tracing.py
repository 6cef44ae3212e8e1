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
    # On the CPU every stratified draw takes the torch route, whose
    # rejection check reads the host once a draw.
    assert c["sampling.draws_plain"] == reads["host_reads.sampling"]
    assert "sampling.draws_kernel" not in c
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


# --- the treelet dispatch's stages and counters ---------------------------

TRAVERSE_SPANS = {"traverse.sort", "traverse.probe", "traverse.cull",
                  "traverse.layout", "traverse.walk", "traverse.merge",
                  "traverse.wide", "traverse.fallback", "traverse.bary"}
TETRA_FS = FilmSettings(res=(16, 16), tile_dim=16)


@pytest.fixture(scope="module")
def tetra(tmp_path_factory):
    """The SPD tetra at depth 6 (16,386 triangles, a treelet scene) as the
    benchmark's configuration writes and loads it."""
    from portbench import harness

    cell = harness.load_cell("spd_tetra.path-strat4")
    cfg = dict(cell.cfg, depth=6, res=list(TETRA_FS.res))
    scene, cam, _ = cell.module.program_scene(
        cfg, torch.device("cpu"), str(tmp_path_factory.mktemp("tetra")))
    assert scene.meta.traversal == "treelet"
    return scene, cam


def _tetra_frame(tetra):
    scene, cam = tetra
    return render_frame(scene, cam, TETRA_FS, StratifiedSampler(1, 1),
                        PathParams(2), wave_tiles=1, seed=5)


def _rays(scene, n, seed):
    """n rays from around the tetrahedron toward it, and their t_max."""
    g = torch.Generator().manual_seed(seed)
    o = torch.rand((n, 3), generator=g) * 4.0 - 2.0
    o[:, 1] = o[:, 1].abs() + 0.2
    target = torch.rand((n, 3), generator=g) * torch.tensor([1.0, 1.4, 1.0])
    d = target - o
    d = d / d.norm(dim=1, keepdim=True)
    return o, d, torch.full((n,), 1e30)


def test_traverse_spans_in_a_frame(tetra, tmp_path):
    """A depth-6 frame under torch.profiler: the dispatch's stages are
    registered spans, nested inside the integrator's queries."""
    assert TRAVERSE_SPANS <= set(profiling.SCOPES)
    plain = _tetra_frame(tetra)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _tetra_frame(tetra)
    assert torch.equal(traced.film.tiles_buf, plain.film.tiles_buf)
    events = _trace_of(prof, tmp_path)
    tid = next(e["tid"] for e in events if e.get("name") == "renderer.launch")
    parents = _parents(_ranges(events, tid))
    names = {n for n, _ in parents}
    assert names <= set(profiling.SCOPES)
    assert {"traverse.probe", "traverse.cull", "traverse.layout",
            "traverse.walk", "traverse.merge", "traverse.bary"} <= names
    for name, parent in parents:
        if name.startswith("traverse."):
            assert parent in ("trace.closest", "trace.occlusion"), (name,
                                                                    parent)


def test_traverse_spans_off_without_profiler(tetra, monkeypatch):
    """Without a profiler no stage of the dispatch enters a range."""
    assert not profiling.profiler_on()

    def refuse(*args, **kw):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert _tetra_frame(tetra).ray_count > 0


def test_dispatch_lanes_and_sort_spans(tetra, tmp_path):
    """dispatch_lanes counts the real lanes of each call, before padding
    to 128; a sorted query (no skip_sort) sorts and unsorts in spans."""
    scene, _ = tetra
    o, d, t_max = _rays(scene, 300, 1)
    traverse.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        hit = traverse.intersect(scene.data, scene.meta, o, d, t_max)
    occ = traverse.any_intersect(scene.data, scene.meta, o[:200], d[:200],
                                 t_max[:200],
                                 torch.full((200,), -2, dtype=torch.int32))
    c = traverse.counts()
    assert c["dispatch_lanes"] == 500 and c["fallback_lanes"] == 0
    assert hit.hit.any() and torch.equal(occ, hit.hit[:200])
    names = [n for _, _, n, _ in _ranges(_trace_of(prof, tmp_path))]
    assert names.count("traverse.sort") == 2
    traverse.reset_counts()
    assert traverse.counts()["dispatch_lanes"] == 0


@pytest.mark.parametrize("query", ["closest", "any"])
def test_forced_fallback_and_wide_rerun(tetra, query, monkeypatch, tmp_path):
    """fallback_lanes counts the real lanes of a wave sent to the treelet
    walk, in a traverse.fallback span; a candidate width of 1 makes lanes
    overflow into the wide re-run's span; the verdicts hold."""
    from yuki_tpu_torch.ops import trace_stream as ts

    scene, _ = tetra
    o, d, t_max = _rays(scene, 300, 2)
    skip = torch.full((300,), -2, dtype=torch.int32)

    def run():
        if query == "closest":
            return traverse.intersect(scene.data, scene.meta, o, d, t_max,
                                      skip_sort=True).prim
        return traverse.any_intersect(scene.data, scene.meta, o, d, t_max,
                                      skip, skip_sort=True)

    want = run()
    monkeypatch.setattr(ts, "C_MAIN", 1)
    traverse.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.equal(run(), want)
    c = traverse.counts()
    assert c["overflow_rays"] > 0 and c["wide_reruns"] == 1
    assert c["fallback_lanes"] == 0
    wide = {n for _, _, n, _ in _ranges(_trace_of(prof, tmp_path))}
    assert {"traverse.wide", "traverse.cull"} <= wide
    monkeypatch.setattr(ts, "OV_CAP", -1)
    traverse.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.equal(run(), want)
    c = traverse.counts()
    assert c["fallbacks"] == 1 and c["fallback_lanes"] == 300
    assert c["dispatch_lanes"] == 300
    parents = _parents(_ranges(_trace_of(prof, tmp_path)))
    assert ("traverse.fallback", None) in parents


def _readings(counts, kernels=(), frames=1, trace=True):
    from types import SimpleNamespace

    from portbench.trace import TraceSummary

    t = (TraceSummary(window_s=1.0, busy_s=0.5, frames=frames,
                      launches=len(kernels), kernels=list(kernels))
         if trace else None)
    return {"win": SimpleNamespace(counts=counts, traced_frames=frames),
            "trace": t}


def test_traversal_metric_readers(scene_and_cam):
    """The three readers on hand-made readings, and None where a run has
    no dispatch: a Cornell frame's counters, or a program without the
    counters."""
    from portbench.metrics import (fallback_lane_pct, overflow_lane_pct,
                                   traversal_ms_per_frame)

    names = traversal_ms_per_frame.kernel_names()
    assert {"slot_closest_kernel", "slot_any_kernel", "cull_kernel",
            "rows_closest_kernel", "rows_any_kernel"} <= names
    assert not names & {"dense_closest_kernel", "dense_any_kernel",
                        "shade_kernel", "bounce_kernel"}
    kernels = [("void slot_closest_kernel<false>(float const*)", 0.003),
               ("cull_kernel", 0.001), ("dense_closest_kernel", 0.5),
               ("void at::native::elementwise_kernel<128, 2>", 0.25)]
    r = _readings({"dispatch_lanes": 2000, "fallback_lanes": 500,
                   "overflow_rays": 30}, kernels, frames=2)
    assert traversal_ms_per_frame.read(r) == pytest.approx(2.0)
    assert fallback_lane_pct.read(r) == 25.0
    assert overflow_lane_pct.read(r) == 1.5
    assert traversal_ms_per_frame.read(_readings({}, kernels[2:])) is None
    assert traversal_ms_per_frame.read(_readings({}, trace=False)) is None
    # The parent program: no dispatch_lanes counter.
    parent = _readings({"overflow_rays": 3, "fallbacks": 0}, kernels)
    assert fallback_lane_pct.read(parent) is None
    assert overflow_lane_pct.read(parent) is None
    traverse.reset_counts()
    _frame(scene_and_cam, "path")
    cornell = _readings(traverse.counts())
    assert cornell["win"].counts["dispatch_lanes"] == 0
    assert fallback_lane_pct.read(cornell) is None
    assert overflow_lane_pct.read(cornell) is None
