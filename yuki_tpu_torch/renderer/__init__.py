"""Wave renderer: port of ``yuki_tpu/renderer/__init__.py``'s
``make_wave_renderer`` (:60-172) and of the synchronous, non-accumulating
wave loop of its manager thread (:383-436) as ``render_frame``.

Only the path tracer is ported, with both samplers (UniformSampler and
StratifiedSampler).  Scenes that pass
``path_fused.wave_supported`` take the fused wave (:107-121) unless
``path_fused.PATH_FUSED_MODE`` is "off"; every other scene takes camera
rays + ``integrators.path_li`` (:122-128), over the dense queries or the
treelet dispatch, where ``check_path_li_supported`` accepts it; anything
else raises ``NotImplementedError`` naming what is missing rather than
running another path.  The threaded ``Renderer`` facade (launch /
check_status / kill, progress and ETA, accumulate mode) is not ported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..camera import Camera, CameraParameters
from ..film import Film, FilmSettings, film_tiles
from ..integrators import PathParams, check_path_li_supported, path_li
from ..ops import path_fused, shade_fused
from ..sampling import SampleCtx


def make_wave_renderer(scene, camera: Camera, sampler, integrator,
                       tile_dim: int, wave_tiles: int,
                       samples_per_launch: int = 1):
    """Build the per-wave render step.

    Returns fn(tile_origins [B,2] int tensor, sample_index int, seed int)
      -> (pixels [B,td,td,3] f32, rays f32 scalar tensor)
    on the scene's device.  Every lane is one pixel sample (Integrator::
    render's per-pixel loop, integrators/mod.rs:119-185, flattened).

    ``samples_per_launch`` > 1 renders that many consecutive sample
    generations per call and returns their pixel SUM, added in sample
    order as yuki_tpu's scan does (:154-164).  ``wave_tiles`` is the
    intended wave size; a call may pass fewer tiles."""
    if not isinstance(integrator, PathParams):
        raise NotImplementedError(
            f"integrator {integrator!r}: only PathParams is ported "
            "(Whitted and the debug integrators are not ported)"
        )
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

    if (path_fused.PATH_FUSED_MODE != "off"
            and path_fused.wave_supported(meta, sampler)):
        tables = path_fused.make_tables(scene, camera, integrator)

        def render_one(origins, sample_index: int, seed: int):
            px, py = pixels(origins)
            li, rcount = path_fused.path_li_wave(tables, px, py,
                                                 sample_index, seed, sampler)
            return li, rcount.to(torch.float32).sum()
    else:
        check_path_li_supported(meta, sampler)
        tables = shade_fused.make_shade_tables(scene, integrator)

        def render_one(origins, sample_index: int, seed: int):
            px, py = pixels(origins)
            ctx = SampleCtx(px=px, py=py, sample_index=sample_index,
                            seed=seed)
            u = sampler.get_2d(ctx, 0)
            p_film = torch.stack([px.to(torch.float32),
                                  py.to(torch.float32)], dim=-1) + u
            o, d = camera.ray(p_film)
            res = path_li(scene, meta, integrator, sampler, ctx,
                          o.contiguous(), d.contiguous(), tables, dim=2)
            return res.li, res.ray_count.to(torch.float32).sum()

    def call(origins, sample_index: int, seed: int):
        origins = torch.as_tensor(origins, device=dev).to(torch.int32)
        li, rays = render_one(origins, int(sample_index), int(seed))
        for k in range(1, samples_per_launch):
            li_k, r_k = render_one(origins, int(sample_index) + k, int(seed))
            li = li + li_k
            rays = rays + r_k
        return li.reshape(origins.shape[0], td, td, 3), rays

    return call


@dataclass
class FrameResult:
    film: Film
    ray_count: int  # closest-hit rays (shadow rays are traced, not counted)
    elapsed_s: float  # wall time of the wave loop, device work included


def render_frame(scene, camera_params: CameraParameters,
                 film_settings: FilmSettings, sampler, integrator,
                 wave_tiles: int = 256, samples_per_launch: int = 1,
                 seed: int = 0) -> FrameResult:
    """Render one frame without accumulation: every wave of tiles loops
    over all its samples, and the film receives the spp-sample average
    once per tile (yuki_tpu renderer/__init__.py:383-436, non-accumulate
    branch, synchronous).  Film and kernels run on the scene's device."""
    if film_settings.accumulate:
        raise NotImplementedError(
            "accumulate mode belongs to the threaded Renderer, not ported"
        )
    rx, ry = film_settings.effective_res()
    camera = Camera.create(camera_params, rx, ry)
    tiles = film_tiles(film_settings)
    spp = sampler.samples_per_pixel
    td = film_settings.tile_dim
    wave_tiles = max(1, min(wave_tiles, len(tiles)))
    # Batch only whole launches (spp % spl == 0 keeps the average exact).
    spl = max(1, min(samples_per_launch, spp))
    while spp % spl:
        spl -= 1
    render_fn = make_wave_renderer(scene, camera, sampler, integrator, td,
                                   wave_tiles, samples_per_launch=spl)
    dev = scene.device
    film = Film(rx, ry, td, device=dev)
    spp_t = torch.tensor(float(spp), dtype=torch.float32, device=dev)

    start = time.monotonic()
    # The ray count sums as yuki_tpu's loop does (:424-431): a wave's
    # launches in float32 on the device, int() of that sum once a wave,
    # the frame's total as a Python int.  A wave's running sum rounds once
    # it passes 2^24.
    ray_count = 0
    for w0 in range(0, len(tiles), wave_tiles):
        wave = tiles[w0: w0 + wave_tiles]
        ids = np.asarray([t.index for t in wave], dtype=np.int64)
        origins = np.asarray([[t.x0, t.y0] for t in wave], dtype=np.int32)
        if len(wave) < wave_tiles:
            # Pad to the wave shape; padded ids fall outside the film and
            # are dropped by add_tiles.
            pad = wave_tiles - len(wave)
            ids = np.concatenate([ids, np.full(pad, film.n_tiles, np.int64)])
            origins = np.concatenate([origins, np.zeros((pad, 2), np.int32)])
        origins_t = torch.as_tensor(origins, device=dev)
        acc = rays_acc = None
        for s in range(0, spp, spl):
            px, rays = render_fn(origins_t, s, seed)
            acc = px if acc is None else acc + px
            rays_acc = rays if rays_acc is None else rays_acc + rays
        film.add_tiles(torch.as_tensor(ids, device=dev), acc / spp_t)
        # One read a wave; add_tiles' masked index already waits for the
        # device.
        ray_count += int(rays_acc.item())
    return FrameResult(film=film, ray_count=ray_count,
                       elapsed_s=time.monotonic() - start)
