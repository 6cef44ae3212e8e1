"""Render runtime: port of ``yuki_tpu/renderer/__init__.py``.

  make_wave_renderer -> the per-wave render step (:60-172), dispatched as
                        yuki_tpu's (:107-140): Path takes the fused dense
                        wave where ``path_fused.wave_supported`` holds
                        (unless ``path_fused.PATH_FUSED_MODE`` is "off"),
                        else camera rays + ``integrators.path_li``;
                        ``WhittedParams`` takes ``whitted_li``; the four
                        debug strings (``integrators.DEBUG_VIEWS``) take
                        their views; anything else raises ValueError.
                        Both samplers run on every route.
  Renderer           -> the facade owning one manager thread: launch /
                        check_status / kill with a monotone render id
                        filtering stale messages (:205-269).
  the manager job    -> the wave loop (:272-444): tiles in spiral order,
                        replicated once per sample generation in
                        accumulate mode, ``mark_tiles``,
                        ``force_single_sample``, progress with a sliding
                        Mrays/s window and an ETA, the film generation
                        checked before every add, cancellation between
                        launches, and one host read a wave (the wave's
                        exact ray count, ``host_reads.renderer``).
  render_frame       -> the same wave loop, called synchronously.

yuki_tpu shards each wave over every local device (:311-330); the port
renders on the scene's device, and shards only where the caller asks for
it through ``parallel.make_sharded_wave_renderer`` (that route runs
``path_li``, not the fused wave).
The manager thread launches on that device's default stream, which the
kernels' wrappers take as the thread's current stream.  The caller reads
the film only after ``RenderFinished`` or ``kill``, which joins the thread.

Under a profiler the wave loop's phases are spans (``profiling.SCOPES``):
``renderer.frame_setup`` (the film, camera, tiles and the wave renderer's
tables), and per wave ``renderer.wave_prep`` (tile ids and origins to the
device, ``mark_tiles``), ``renderer.launch`` (each wave-renderer call),
``renderer.read_rays``, ``renderer.film_add`` and ``renderer.report``.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from ..camera import Camera, CameraParameters
from ..film import Film, FilmSettings, film_tiles
from ..integrators import (DEBUG_VIEWS, PathParams, WhittedParams, path_li,
                           use_fused_shade, whitted_li)
from ..ops import path_fused, shade_fused
from ..profiling import host_read, pass_scope
from ..sampling import SampleCtx, force_single_sample

_log = logging.getLogger("yuki")


@dataclass(frozen=True)
class RenderSettings:
    """renderer/mod.rs:34-38. mark_tiles draws magenta in-progress tiles;
    use_single_render_thread serializes waves to one tile for debugging."""

    mark_tiles: bool = False
    use_single_render_thread: bool = False
    wave_tiles: int = 256  # tiles per wave
    # Sample generations rendered per wave call (non-accumulate mode only;
    # accumulate shows per-sample progress by design).  The wave loop
    # clamps it to the spp and to a divisor of it.
    samples_per_launch: int = 1


def make_wave_renderer(scene, camera: Camera, sampler, integrator,
                       tile_dim: int, wave_tiles: int,
                       samples_per_launch: int = 1):
    """Build the per-wave render step.

    Returns fn(tile_origins [B,2] int tensor, sample_index int, seed int)
      -> (pixels [B,td,td,3] f32, rays int64 scalar tensor)
    on the scene's device.  Every lane is one pixel sample (Integrator::
    render's per-pixel loop, integrators/mod.rs:119-185, flattened).

    ``samples_per_launch`` > 1 renders that many consecutive sample
    generations per call and returns their pixel SUM, added in sample
    order as yuki_tpu's scan does (:154-164).  ``wave_tiles`` is the
    intended wave size; a call may pass fewer tiles."""
    if not isinstance(integrator, (PathParams, WhittedParams)) and (
            integrator not in DEBUG_VIEWS):
        raise ValueError(f"unknown integrator {integrator!r}")
    if wave_tiles < 1 or samples_per_launch < 1:
        raise ValueError("wave_tiles and samples_per_launch must be >= 1")
    meta = scene.meta
    td = tile_dim
    dev = scene.device
    iy, ix = torch.meshgrid(
        torch.arange(td, dtype=torch.int32, device=dev),
        torch.arange(td, dtype=torch.int32, device=dev),
        indexing="ij",
    )

    def pixels(origins):
        px = (origins[:, 0, None, None] + ix[None]).reshape(-1)
        py = (origins[:, 1, None, None] + iy[None]).reshape(-1)
        return px.contiguous(), py.contiguous()

    if (isinstance(integrator, PathParams)
            and path_fused.PATH_FUSED_MODE != "off"
            and path_fused.wave_supported(meta, sampler)):
        tables = path_fused.make_tables(scene, camera, integrator)

        def render_one(origins, sample_index: int, seed: int):
            px, py = pixels(origins)
            li, rcount = path_fused.path_li_wave(tables, px, py,
                                                 sample_index, seed, sampler)
            return li, rcount.sum(dtype=torch.int64)
    else:
        if isinstance(integrator, PathParams):
            tables = (shade_fused.make_shade_tables(scene, integrator)
                      if use_fused_shade(meta, sampler) else None)

            def li_fn(ctx, o, d):
                return path_li(scene, meta, integrator, sampler, ctx, o, d,
                               tables, dim=2)
        elif isinstance(integrator, WhittedParams):
            def li_fn(ctx, o, d):
                return whitted_li(scene, meta, integrator, sampler, ctx, o,
                                  d, dim=2)
        else:
            view = DEBUG_VIEWS[integrator]

            def li_fn(ctx, o, d):
                return view(scene, meta, o, d)

        def render_one(origins, sample_index: int, seed: int):
            px, py = pixels(origins)
            ctx = SampleCtx(px=px, py=py, sample_index=sample_index,
                            seed=seed)
            u = sampler.get_2d(ctx, 0)
            p_film = torch.stack([px.to(torch.float32),
                                  py.to(torch.float32)], dim=-1) + u
            o, d = camera.ray(p_film)
            res = li_fn(ctx, o.contiguous(), d.contiguous())
            return res.li, res.ray_count.sum(dtype=torch.int64)

    def call(origins, sample_index: int, seed: int):
        origins = torch.as_tensor(origins, device=dev).to(torch.int32)
        li, rays = render_one(origins, int(sample_index), int(seed))
        for k in range(1, samples_per_launch):
            li_k, r_k = render_one(origins, int(sample_index) + k, int(seed))
            li = li + li_k
            rays = rays + r_k
        return li.reshape(origins.shape[0], td, td, 3), rays

    return call


# --- status messages (renderer/mod.rs:21-32) ------------------------------


@dataclass
class RenderProgress:
    render_id: int
    tiles_done: int
    tiles_total: int
    current_rays: int
    rays_per_sec: float
    approx_remaining_s: float


@dataclass
class RenderFinished:
    render_id: int
    ray_count: int
    elapsed_s: float


@dataclass
class RenderError:
    """Manager-thread failure surfaced to the caller (the reference panics
    its worker thread and logs via the panic hook, main.rs:74-92; this
    port, like yuki_tpu, propagates it)."""

    render_id: int
    message: str


class Renderer:
    """Facade owning the manager thread (renderer/mod.rs:40-184)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._cancel = threading.Event()
        self._msgs: "queue.Queue" = queue.Queue()
        self._render_id = 0

    def is_active(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def launch(
        self,
        scene,
        camera_params: CameraParameters,
        film: Film,
        sampler,
        integrator,
        film_settings: FilmSettings,
        render_settings: RenderSettings = RenderSettings(),
        force_single_sample_flag: bool = False,
        match_seed: int = 0,
    ) -> int:
        """Kills any in-flight render and starts a new one; returns its id.
        The film must be on the scene's device."""
        self.kill()
        self._render_id += 1
        rid = self._render_id
        self._cancel = threading.Event()
        args = (
            rid, scene, camera_params, film, sampler, integrator,
            film_settings, render_settings, force_single_sample_flag,
            match_seed, self._cancel, self._msgs,
        )
        self._thread = threading.Thread(
            target=_render_job, args=args, daemon=True
        )
        self._thread.start()
        return rid

    def check_status(self) -> List[Union[RenderProgress, RenderFinished,
                                         RenderError]]:
        """Drains messages, dropping those from stale render ids
        (renderer/mod.rs:61-120)."""
        out = []
        while True:
            try:
                msg = self._msgs.get_nowait()
            except queue.Empty:
                break
            if msg.render_id == self._render_id:
                out.append(msg)
        return out

    def kill(self):
        if self._thread is not None and self._thread.is_alive():
            self._cancel.set()
            self._thread.join()
        self._thread = None

    def __del__(self):
        try:
            self.kill()
        except Exception:
            pass


def _render_job(rid, *args):
    msgs = args[-1]
    try:
        done = _wave_loop(rid, *args)
        if done is not None:
            msgs.put(done)
    except Exception as e:  # surface it to the caller (thread context)
        _log.error("render job failed: %s\n%s", e, traceback.format_exc())
        msgs.put(RenderError(render_id=rid,
                             message=f"{type(e).__name__}: {e}"))


def _wave_loop(rid, scene, camera_params, film, sampler, integrator,
               film_settings, render_settings, force_single, seed, cancel,
               msgs) -> Optional[RenderFinished]:
    """The manager job's wave loop (yuki_tpu :287-444) on the scene's
    device.  Puts a RenderProgress on ``msgs`` after every wave; returns
    the RenderFinished message, or None once ``cancel`` is set."""
    dev = scene.device
    if film.tiles_buf.device != dev:
        raise ValueError(f"film on {film.tiles_buf.device}, scene on {dev}")
    with pass_scope("renderer.frame_setup"):
        rx, ry = film_settings.effective_res()
        camera = Camera.create(camera_params, rx, ry)
        if force_single:
            sampler = force_single_sample(sampler)

        tiles = film_tiles(film_settings)
        spp = sampler.samples_per_pixel
        film_generation = film.generation

        # Accumulation replicates the tile list once per sample generation
        # (render_manager.rs:130-143); otherwise each wave loops spp
        # launches.
        if film_settings.accumulate:
            passes = [(s, tiles) for s in range(spp)]
        else:
            passes = [(None, tiles)]

        td = film_settings.tile_dim
        wave_tiles = 1 if render_settings.use_single_render_thread else max(
            1, min(render_settings.wave_tiles, len(tiles))
        )
        # Batch only whole launches (spp % spl == 0 keeps the average
        # exact).
        spl = max(1, min(render_settings.samples_per_launch, spp))
        while spp % spl:
            spl -= 1
        if film_settings.accumulate or isinstance(integrator, str):
            spl = 1
        render_fn = make_wave_renderer(scene, camera, sampler, integrator,
                                       td, wave_tiles,
                                       samples_per_launch=spl)
        spp_t = torch.tensor(float(spp), dtype=torch.float32, device=dev)

    start = time.monotonic()
    # A wave's launches sum their ray counts in int64 on the device, read
    # once a wave: the frame's total is exact.  (yuki_tpu sums a wave in
    # float32, :424-431, which rounds past 2^24.)
    total_rays = 0
    # Work unit = tile-sample in both modes, so that the ETA weighs every
    # sample (:365-373).
    tiles_total = sum(len(t) for _, t in passes) * (
        1 if film_settings.accumulate else spp
    )
    tiles_done = 0
    window = deque(maxlen=16)  # sliding throughput window

    def report(wave_rays, elapsed, units):
        nonlocal tiles_done
        tiles_done += units
        window.append((wave_rays, elapsed, units))
        win_rays = sum(r for r, _, _ in window)
        win_time = max(sum(e for _, e, _ in window), 1e-9)
        win_units = max(sum(n for _, _, n in window), 1)
        msgs.put(RenderProgress(
            render_id=rid,
            tiles_done=tiles_done,
            tiles_total=tiles_total,
            current_rays=total_rays,
            rays_per_sec=win_rays / win_time,
            approx_remaining_s=(tiles_total - tiles_done)
            * (win_time / win_units),
        ))

    for sample_gen, pass_tiles in passes:
        for w0 in range(0, len(pass_tiles), wave_tiles):
            if cancel.is_set():
                return None
            with pass_scope("renderer.wave_prep"):
                wave = pass_tiles[w0: w0 + wave_tiles]
                ids = np.asarray([t.index for t in wave], dtype=np.int64)
                origins = np.asarray([[t.x0, t.y0] for t in wave],
                                     dtype=np.int32)
                if len(wave) < wave_tiles:
                    # Pad to the wave shape; padded ids fall outside the
                    # film and are dropped by add_tiles and mark_tiles.
                    pad = wave_tiles - len(wave)
                    ids = np.concatenate(
                        [ids, np.full(pad, film.n_tiles, np.int64)])
                    origins = np.concatenate(
                        [origins, np.zeros((pad, 2), np.int32)])
                ids_t = torch.as_tensor(ids, device=dev)
                origins_t = torch.as_tensor(origins, device=dev)
                if render_settings.mark_tiles:
                    film.mark_tiles(ids_t)
            t0 = time.monotonic()
            if film_settings.accumulate:
                with pass_scope("renderer.launch"):
                    px, rays_acc = render_fn(origins_t, sample_gen, seed)
                units = len(wave)
            else:
                acc = rays_acc = None
                for s in range(0, spp, spl):
                    if cancel.is_set():
                        return None
                    # render_fn returns the SUM over spl consecutive
                    # sample generations; rays accumulate on the device,
                    # read once a wave.
                    with pass_scope("renderer.launch"):
                        px, rays = render_fn(origins_t, s, seed)
                    acc = px if acc is None else acc + px
                    rays_acc = rays if rays_acc is None else rays_acc + rays
                units = len(wave) * spp
            with pass_scope("renderer.read_rays"):
                wave_rays = host_read(rays_acc, "renderer")
            with pass_scope("renderer.film_add"):
                # Without accumulation, one generation holding the
                # spp-sample average, so the film's count-normalize yields
                # the reference's mean.
                if film.generation == film_generation:
                    film.add_tiles(ids_t, px if film_settings.accumulate
                                   else acc / spp_t)
            total_rays += wave_rays
            with pass_scope("renderer.report"):
                report(wave_rays, time.monotonic() - t0, units)

    return RenderFinished(render_id=rid, ray_count=total_rays,
                          elapsed_s=time.monotonic() - start)


@dataclass
class FrameResult:
    film: Film
    ray_count: int  # closest-hit rays (shadow rays are traced, not counted)
    elapsed_s: float  # wall time of the wave loop, device work included


def render_frame(scene, camera_params: CameraParameters,
                 film_settings: FilmSettings, sampler, integrator,
                 wave_tiles: int = 256, samples_per_launch: int = 1,
                 seed: int = 0) -> FrameResult:
    """Render one frame into a new film on the scene's device: the
    Renderer's wave loop, called synchronously in this thread; its
    progress messages are dropped.  Without accumulation every wave loops
    over all its samples and the film receives the spp-sample average once
    per tile; with it, one launch per tile-sample generation."""
    rx, ry = film_settings.effective_res()
    with pass_scope("renderer.frame_setup"):
        film = Film(rx, ry, film_settings.tile_dim, device=scene.device)
    done = _wave_loop(
        0, scene, camera_params, film, sampler, integrator, film_settings,
        RenderSettings(wave_tiles=wave_tiles,
                       samples_per_launch=samples_per_launch),
        False, seed, threading.Event(), queue.SimpleQueue(),
    )
    return FrameResult(film=film, ray_count=done.ray_count,
                       elapsed_s=done.elapsed_s)

