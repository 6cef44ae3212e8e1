"""Headless rendering (app/headless.rs:24-158): port of
``yuki_tpu/app/headless.py``.  Renders to an EXR with a CR-overwritten
progress line, polling the renderer every 100 ms; a failure of the render
thread is raised as RuntimeError."""

from __future__ import annotations

import sys
import time

from ..film import film_or_new
from ..renderer import Renderer, RenderError, RenderFinished, RenderProgress
from ..tonemap import FilmicParams, HeatmapParams, filmic, heatmap
from .settings import InitialSettings
from .util import try_load_scene, write_exr


def render(settings: InitialSettings, out_path: str, quiet: bool = False,
           device=None) -> dict:
    """Blocking headless render on ``device`` (None: the card); returns
    stats {rays, elapsed_s, mrays_s}."""
    scene, cam_params, scene_film, _secs = try_load_scene(
        settings.load_settings, device=device)
    film_settings = settings.film_settings
    if settings.load_settings.path:
        # Scene files carry their own film settings like the reference; CLI
        # settings override resolution only if explicitly provided.
        film_settings = scene_film if film_settings is None else film_settings

    film = film_or_new(None, film_settings, device=scene.device)
    renderer = Renderer()
    renderer.launch(
        scene,
        cam_params,
        film,
        settings.sampler,
        settings.integrator,
        film_settings,
        settings.render_settings,
        match_seed=0,
    )

    stats = None
    try:
        while stats is None:
            time.sleep(0.1)
            # Read is_active first: a thread that has ended has put its
            # last message, which this drain then sees.
            active = renderer.is_active()
            for msg in renderer.check_status():
                if isinstance(msg, RenderProgress):
                    if not quiet:
                        sys.stdout.write(
                            f"\r{msg.tiles_done}/{msg.tiles_total} tiles "
                            f"{msg.rays_per_sec / 1e6:5.2f} Mrays/s "
                            f"ETA {msg.approx_remaining_s:5.1f}s   "
                        )
                        sys.stdout.flush()
                elif isinstance(msg, RenderError):
                    raise RuntimeError(f"render failed: {msg.message}")
                elif isinstance(msg, RenderFinished):
                    stats = {
                        "rays": msg.ray_count,
                        "elapsed_s": msg.elapsed_s,
                        "mrays_s": msg.ray_count / max(msg.elapsed_s, 1e-9)
                        / 1e6,
                    }
            if stats is None and not active:
                raise RuntimeError("render thread ended without finishing")
    finally:
        renderer.kill()
    if not quiet:
        print()

    img = film.image_device()  # sample-normalized [H,W,3]
    tm = settings.tone_map
    if tm.kind == "Filmic":
        img = filmic(img, FilmicParams(exposure=tm.exposure))
    elif tm.kind == "Heatmap":
        img = heatmap(
            img,
            HeatmapParams(
                channel=tm.channel, min_val=tm.min_val, max_val=tm.max_val
            ),
        )
    # Raw: sample-normalized linear radiance, like the reference's raw EXR.
    write_exr(out_path, img)
    if not quiet:
        print(
            f"Wrote {out_path}: {stats['rays']} rays in "
            f"{stats['elapsed_s']:.2f}s ({stats['mrays_s']:.2f} Mrays/s)"
        )
    return stats
