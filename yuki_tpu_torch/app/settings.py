"""YAML settings: port of ``yuki_tpu/app/settings.py`` (InitialSettings
parity, yuki/src/app/mod.rs:19-26).

All fields optional with code defaults, round-trippable — the reference
reads ``settings.yaml`` at startup (main.rs:140-153) and writes it back from
the UI.  Enum spellings match the reference's serde strings so a yuki
settings.yaml loads here unchanged (modulo GL-only options), and
``save_settings`` writes yuki_tpu's text.  PyYAML is imported only when a
file is read or written.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

from ..film import FilmSettings
from ..integrators import PathParams, WhittedParams
from ..renderer import RenderSettings
from ..sampling import StratifiedSampler, UniformSampler


@dataclass
class SceneLoadSettings:
    """scene/mod.rs:24-39."""

    path: str = ""
    split_method: str = "SurfaceAreaHeuristic"  # | Middle | EqualCounts
    max_shapes_in_node: int = 1

    def split_method_key(self) -> str:
        return {
            "SurfaceAreaHeuristic": "sah",
            "Middle": "middle",
            "EqualCounts": "equal_counts",
        }[self.split_method]


@dataclass
class ToneMapSettings:
    kind: str = "Filmic"  # Raw | Filmic | Heatmap
    exposure: float = 1.0
    channel: Optional[int] = None
    min_val: float = 0.0
    max_val: float = 1.0


@dataclass
class InitialSettings:
    film_settings: FilmSettings = field(default_factory=FilmSettings)
    sampler: Union[UniformSampler, StratifiedSampler] = field(
        default_factory=StratifiedSampler
    )
    integrator: Union[WhittedParams, PathParams, str] = field(
        default_factory=WhittedParams
    )
    tone_map: ToneMapSettings = field(default_factory=ToneMapSettings)
    render_settings: RenderSettings = field(default_factory=RenderSettings)
    load_settings: SceneLoadSettings = field(default_factory=SceneLoadSettings)


def _sampler_from_dict(d: dict):
    kind = d.get("type", "Stratified")
    if kind == "Uniform":
        return UniformSampler(pixel_samples=int(d.get("pixel_samples", 1)))
    ps = d.get("pixel_samples", [1, 1])
    if isinstance(ps, int):
        ps = [ps, ps]
    return StratifiedSampler(
        pixel_samples_x=int(ps[0]),
        pixel_samples_y=int(ps[1]),
        symmetric_dimensions=bool(d.get("symmetric_dimensions", True)),
        jitter=bool(d.get("jitter_samples", True)),
    )


# The debug views' settings-file names -> the integrators' registry keys.
VIEW_NAMES = {
    "BVHIntersections": "bvh_intersections",
    "GeometryNormals": "geometry_normals",
    "ShadingNormals": "shading_normals",
    "ShadingUVs": "shading_uvs",
}


def _integrator_from_dict(d: dict):
    kind = d.get("type", "Whitted")
    if kind == "Whitted":
        return WhittedParams(max_depth=int(d.get("max_depth", 3)))
    if kind == "Path":
        clamp = d.get("indirect_clamp", None)
        return PathParams(
            max_depth=int(d.get("max_depth", 3)),
            indirect_clamp=None if clamp is None else float(clamp),
        )
    return VIEW_NAMES[kind]


def load_settings(path: Optional[str]) -> InitialSettings:
    s = InitialSettings()
    if not path:
        return s
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    if fs := raw.get("film_settings"):
        res = fs.get("res", [640, 480])
        if isinstance(res, dict):
            res = [res.get("x", 640), res.get("y", 480)]
        s.film_settings = FilmSettings(
            res=(int(res[0]), int(res[1])),
            tile_dim=int(fs.get("tile_dim", 16)),
            clear=bool(fs.get("clear", True)),
            accumulate=bool(fs.get("accumulate", False)),
            sixteenth_res=bool(fs.get("sixteenth_res", False)),
        )
    if sp := raw.get("sampler_settings"):
        s.sampler = _sampler_from_dict(sp)
    if ig := raw.get("scene_integrator"):
        s.integrator = _integrator_from_dict(ig)
    if tm := raw.get("tone_map"):
        s.tone_map = ToneMapSettings(
            kind=tm.get("type", "Filmic"),
            exposure=float(tm.get("exposure", 1.0)),
            channel=tm.get("channel"),
            min_val=float(tm.get("min", 0.0)),
            max_val=float(tm.get("max", 1.0)),
        )
    if rs := raw.get("render_settings"):
        s.render_settings = RenderSettings(
            mark_tiles=bool(rs.get("mark_tiles", False)),
            use_single_render_thread=bool(
                rs.get("use_single_render_thread", False)
            ),
            wave_tiles=int(rs.get("wave_tiles", 256)),
            samples_per_launch=int(rs.get("samples_per_launch", 1)),
        )
    if ls := raw.get("load_settings"):
        s.load_settings = SceneLoadSettings(
            path=str(ls.get("path", "")),
            split_method=str(ls.get("split_method", "SurfaceAreaHeuristic")),
            max_shapes_in_node=int(ls.get("max_shapes_in_node", 1)),
        )
    return s


def save_settings(s: InitialSettings, path: str) -> None:
    if isinstance(s.sampler, UniformSampler):
        sampler = {"type": "Uniform", "pixel_samples": s.sampler.pixel_samples}
    else:
        sampler = {
            "type": "Stratified",
            "pixel_samples": [s.sampler.pixel_samples_x, s.sampler.pixel_samples_y],
            "symmetric_dimensions": s.sampler.symmetric_dimensions,
            "jitter_samples": s.sampler.jitter,
        }
    if isinstance(s.integrator, WhittedParams):
        integrator = {"type": "Whitted", "max_depth": s.integrator.max_depth}
    elif isinstance(s.integrator, PathParams):
        integrator = {
            "type": "Path",
            "max_depth": s.integrator.max_depth,
            "indirect_clamp": s.integrator.indirect_clamp,
        }
    else:
        integrator = {
            "type": {v: k for k, v in VIEW_NAMES.items()}[s.integrator]
        }
    doc = {
        "film_settings": {
            "res": list(s.film_settings.res),
            "tile_dim": s.film_settings.tile_dim,
            "clear": s.film_settings.clear,
            "accumulate": s.film_settings.accumulate,
            "sixteenth_res": s.film_settings.sixteenth_res,
        },
        "sampler_settings": sampler,
        "scene_integrator": integrator,
        "tone_map": {
            "type": s.tone_map.kind,
            "exposure": s.tone_map.exposure,
            "channel": s.tone_map.channel,
            "min": s.tone_map.min_val,
            "max": s.tone_map.max_val,
        },
        "render_settings": {
            "mark_tiles": s.render_settings.mark_tiles,
            "use_single_render_thread": s.render_settings.use_single_render_thread,
            "wave_tiles": s.render_settings.wave_tiles,
            "samples_per_launch": s.render_settings.samples_per_launch,
        },
        "load_settings": {
            "path": s.load_settings.path,
            "split_method": s.load_settings.split_method,
            "max_shapes_in_node": s.load_settings.max_shapes_in_node,
        },
    }
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(doc, f, sort_keys=False)
