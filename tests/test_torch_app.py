"""The port's app layer against yuki_tpu's: the tone map, the EXR writer,
the settings file, the film's bookkeeping, the threaded Renderer (the
cases of tests/test_renderer.py on the port's Cornell box, on the CPU)
and the command line, run as ``python -m yuki_tpu_torch --device cpu``."""

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from yuki_tpu_torch.film import FilmSettings, film_or_new
from yuki_tpu_torch.integrators import PathParams
from yuki_tpu_torch.renderer import (Renderer, RenderError, RenderFinished,
                                     RenderProgress, RenderSettings,
                                     render_frame)
from yuki_tpu_torch.sampling import StratifiedSampler, UniformSampler

torch.set_num_threads(2)

REPO = Path(__file__).parent.parent


def same_bits(a, b, name=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, name
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), name


# --- tone map ---------------------------------------------------------------


def _radiance(seed=0):
    rng = np.random.default_rng(seed)
    x = ((rng.random((48, 64, 3)) * 4.0) ** 2).astype(np.float32)
    x[0, :4] = [[0, 0, 0], [1e-4, 1e-3, 5e-3], [1, 1, 1], [50, 0.5, 0]]
    return x


# XLA's CPU dot runs each 3-term matrix row as an FMA chain; the port sums
# the three products left to right, so the ACES matrices differ by an ulp
# before the fitted curve (measured: at most 8.8e-6 relative after it).
ACES_RTOL = 2e-5
# torch.pow and XLA's pow differ by an ulp on some inputs (measured:
# 2.2e-7 relative).
SRGB_RTOL = 1e-6


@pytest.mark.parametrize("exposure", [None, 1.0, 0.35, 2.5])
def test_filmic_matches(exposure):
    from yuki_tpu import tonemap as jt
    from yuki_tpu_torch import tonemap as tt

    x = _radiance()
    if exposure is None:
        ref, got = jt.aces_fitted(x), tt.aces_fitted(torch.from_numpy(x))
    else:
        ref = jt.filmic(x, jt.FilmicParams(exposure))
        got = tt.filmic(torch.from_numpy(x), tt.FilmicParams(exposure))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=ACES_RTOL, atol=1e-7)


@pytest.mark.parametrize("channel", [None, 0, 1, 2])
def test_heatmap_bit_for_bit(channel):
    from yuki_tpu import tonemap as jt
    from yuki_tpu_torch import tonemap as tt

    x = _radiance(1)
    ref = jt.heatmap(x, jt.HeatmapParams(channel, 0.1, 7.3))
    got = tt.heatmap(torch.from_numpy(x), tt.HeatmapParams(channel, 0.1, 7.3))
    same_bits(ref, got.numpy(), "heatmap")
    assert tt.find_min_max(torch.from_numpy(x), channel) == \
        jt.find_min_max(x, channel)


def test_srgb_encode_matches():
    from yuki_tpu import tonemap as jt
    from yuki_tpu_torch import tonemap as tt

    y = (np.random.default_rng(2).random((48, 64, 3)) * 1.2 - 0.1).astype(
        np.float32)
    np.testing.assert_allclose(tt.srgb_encode(torch.from_numpy(y)).numpy(),
                               np.asarray(jt.srgb_encode(y)),
                               rtol=SRGB_RTOL, atol=0)


# --- EXR --------------------------------------------------------------------


def test_exr_same_bytes_and_round_trip(tmp_path):
    from yuki_tpu.app import exr as jexr
    from yuki_tpu_torch.app import exr

    img = _radiance(3)[:37, :23]
    jexr.write_exr(str(tmp_path / "j.exr"), img)
    exr.write_exr(str(tmp_path / "t.exr"), img)
    exr.write_exr(str(tmp_path / "tensor.exr"), torch.from_numpy(img))
    ref = (tmp_path / "j.exr").read_bytes()
    assert (tmp_path / "t.exr").read_bytes() == ref
    assert (tmp_path / "tensor.exr").read_bytes() == ref
    same_bits(exr.read_exr(str(tmp_path / "j.exr")), img)
    same_bits(jexr.read_exr(str(tmp_path / "t.exr")), img)


# --- settings ---------------------------------------------------------------


def _settings_cases(pkg):
    """The same InitialSettings built from either package's classes."""
    import importlib

    st = importlib.import_module(f"{pkg}.app.settings")
    intg = importlib.import_module(f"{pkg}.integrators")
    sam = importlib.import_module(f"{pkg}.sampling")
    ren = importlib.import_module(f"{pkg}.renderer")
    fs = importlib.import_module(f"{pkg}.film")
    return st, {
        "defaults": st.InitialSettings(),
        "path": st.InitialSettings(
            film_settings=fs.FilmSettings(res=(320, 200), tile_dim=8,
                                          accumulate=True),
            sampler=sam.UniformSampler(pixel_samples=16),
            integrator=intg.PathParams(max_depth=7, indirect_clamp=2.5),
            render_settings=ren.RenderSettings(mark_tiles=True,
                                               wave_tiles=32,
                                               samples_per_launch=4),
            load_settings=st.SceneLoadSettings(path="x.pbrt",
                                               split_method="Middle",
                                               max_shapes_in_node=4)),
        "stratified": st.InitialSettings(
            sampler=sam.StratifiedSampler(pixel_samples_x=4,
                                          pixel_samples_y=2, jitter=False),
            integrator=intg.WhittedParams(max_depth=5)),
        "debug": st.InitialSettings(integrator="shading_normals"),
        "heatmap": st.InitialSettings(
            tone_map=st.ToneMapSettings(kind="Heatmap", exposure=1.5,
                                        channel=2, min_val=0.1,
                                        max_val=9.0)),
    }


def _fields(s) -> dict:
    """Every section of an InitialSettings as plain values, with the
    sampler's and integrator's class names."""
    out = {}
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = (type(v).__name__, dataclasses.asdict(v))
        else:
            out[f.name] = v
    return out


@pytest.mark.parametrize("case", ["defaults", "path", "stratified", "debug",
                                  "heatmap"])
def test_settings_match(tmp_path, case):
    jst, jcases = _settings_cases("yuki_tpu")
    tst, tcases = _settings_cases("yuki_tpu_torch")
    assert _fields(tcases[case]) == _fields(jcases[case])
    jst.save_settings(jcases[case], str(tmp_path / "j.yaml"))
    tst.save_settings(tcases[case], str(tmp_path / "t.yaml"))
    text = (tmp_path / "j.yaml").read_text()
    assert (tmp_path / "t.yaml").read_text() == text
    back = tst.load_settings(str(tmp_path / "j.yaml"))
    assert _fields(back) == _fields(jst.load_settings(str(tmp_path
                                                          / "j.yaml")))
    assert _fields(back) == _fields(tcases[case])


# --- film -------------------------------------------------------------------


def test_film_matches_yuki_tpu():
    """The same waves, markers and clears on yuki_tpu's Film and the
    port's, over three generations: sums, counts, images and raw sums bit
    for bit after every step, padding ids dropped."""
    import jax.numpy as jnp

    from yuki_tpu.film import Film as JFilm
    from yuki_tpu.film import film_or_new as jfilm_or_new
    from yuki_tpu_torch.film import Film

    rng = np.random.default_rng(4)
    jf, tf = JFilm(40, 36, 8), Film(40, 36, 8, device="cpu")
    n = tf.n_tiles

    def check(step):
        same_bits(jf.tiles_buf, tf.tiles_buf.numpy(), f"{step}: sums")
        same_bits(jf.samples, tf.samples.numpy(), f"{step}: counts")
        same_bits(jf.image(), tf.image(), f"{step}: image")
        same_bits(jf.raw_sums(), tf.raw_sums(), f"{step}: raw sums")
        assert jf.generation == tf.generation

    for gen in range(3):
        for wave in range(4):
            ids = rng.permutation(n + 3)[:7].astype(np.int32)
            px = (rng.random((7, 8, 8, 3)) * 3).astype(np.float32)
            jf.add_tiles(jnp.asarray(ids), jnp.asarray(px))
            tf.add_tiles(torch.from_numpy(ids), torch.from_numpy(px))
            check(f"gen {gen} wave {wave}")
            marks = rng.permutation(n + 2)[:3].astype(np.int32)
            jf.mark_tiles(jnp.asarray(marks))
            tf.mark_tiles(torch.from_numpy(marks))
            check(f"gen {gen} marks {wave}")
        jf.clear()
        tf.clear()
        check(f"clear {gen}")
    keep = FilmSettings(res=(40, 36), tile_dim=8, clear=False)
    from yuki_tpu.film import FilmSettings as JFilmSettings

    jkeep = JFilmSettings(res=(40, 36), tile_dim=8, clear=False)
    assert jfilm_or_new(jf, jkeep) is jf and film_or_new(tf, keep) is tf
    check("reused")
    assert film_or_new(tf, FilmSettings(res=(40, 36), tile_dim=8),
                       device="cpu") is not tf


# --- Renderer (tests/test_renderer.py:43-185 on the port) -------------------


@pytest.fixture(scope="module")
def scene_and_cam():
    from yuki_tpu_torch.scene.cornell import cornell

    scene, cam_params, _ = cornell(device="cpu")
    return scene, cam_params


def run_to_completion(renderer, timeout=120.0):
    msgs = []
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        time.sleep(0.05)
        for m in renderer.check_status():
            msgs.append(m)
            if isinstance(m, (RenderFinished, RenderError)):
                return msgs
        if not renderer.is_active():
            break
    return msgs + renderer.check_status()


def _render(scene, cam, fs, sampler, params, settings=RenderSettings(),
            seed=0, force_single=False):
    film = film_or_new(None, fs, device="cpu")
    r = Renderer()
    r.launch(scene, cam, film, sampler, params, fs, settings,
             force_single_sample_flag=force_single, match_seed=seed)
    msgs = run_to_completion(r)
    r.kill()
    assert isinstance(msgs[-1], RenderFinished), msgs[-1]
    return film, msgs


def test_full_render_finishes(scene_and_cam):
    scene, cam = scene_and_cam
    fs = FilmSettings(res=(64, 48), tile_dim=16)
    film, msgs = _render(scene, cam, fs, UniformSampler(2), PathParams(2),
                         RenderSettings(wave_tiles=6))
    assert msgs[-1].ray_count > 0
    img = film.image()
    assert img.shape == (48, 64, 3) and np.isfinite(img).all()
    assert img.mean() > 0.01
    assert (film.samples.numpy() == 1).all()


def test_progress_messages(scene_and_cam):
    scene, cam = scene_and_cam
    fs = FilmSettings(res=(64, 48), tile_dim=16)
    _, msgs = _render(scene, cam, fs, UniformSampler(1), PathParams(1),
                      RenderSettings(wave_tiles=2))
    progress = [m for m in msgs if isinstance(m, RenderProgress)]
    assert len(progress) == 6
    assert [m.tiles_done for m in progress] == [2, 4, 6, 8, 10, 12]
    assert progress[-1].tiles_done == progress[-1].tiles_total
    assert progress[-1].approx_remaining_s == 0.0
    assert progress[-1].rays_per_sec > 0
    assert progress[-1].current_rays == msgs[-1].ray_count


def test_accumulation_generations(scene_and_cam):
    """Accumulate mode: one launch per sample generation and tile; the
    counts track them, and the image is the mean of the single-sample
    frames (render_manager.rs:130-143): bit for bit the non-accumulate
    frame of the same spp and seed, whose wave adds the same samples in
    the same order and divides once (0 + a + b over 2 both ways)."""
    scene, cam = scene_and_cam
    fs = FilmSettings(res=(32, 32), tile_dim=16, accumulate=True)
    film, _ = _render(scene, cam, fs, UniformSampler(2), PathParams(1),
                      seed=5)
    assert (film.samples.numpy() == 2).all()
    ref = render_frame(scene, cam, dataclasses.replace(fs, accumulate=False),
                       UniformSampler(2), PathParams(1), seed=5)
    assert (ref.film.samples.numpy() == 1).all()
    same_bits(film.image(), ref.film.image())


# One wave of 8 tiles, so that yuki_tpu's renderer, which rounds a wave
# up to a multiple of the devices it shards over, traces no padding tile
# on the 8-device CPU mesh either and both ray counts count the same lanes.
RENDERER_MODES = {
    "accumulate": (dict(accumulate=True), RenderSettings(wave_tiles=8),
                   False),
    "accumulate_marked": (dict(accumulate=True),
                          RenderSettings(wave_tiles=8, mark_tiles=True),
                          False),
    "marked": (dict(), RenderSettings(wave_tiles=8, mark_tiles=True), False),
    "force_single": (dict(), RenderSettings(wave_tiles=8), True),
}


@pytest.mark.parametrize("mode", list(RENDERER_MODES))
def test_renderer_matches_yuki_tpu(scene_and_cam, mode):
    """The port's Renderer against yuki_tpu's on the same Cornell box, the
    same settings and seed: accumulate passes, the magenta tile marks
    (drawn before a wave and added to), and force_single_sample.  The
    films' sample counts are equal; the sums and the images hold under
    _assert_parity's deep bounds, as the goldens do, since yuki_tpu
    renders on the CPU through its XLA path_li chain (the port's wave
    agrees with it to 2.4e-6 of the image's peak at depth 1, but not to
    the shallow rtol on near-black values).  A pass that repeated a
    sample index, or a mark left out or kept, moves most pixels."""
    import torch_parity as tp
    from yuki_tpu import film as jfilm
    from yuki_tpu import integrators as jintg
    from yuki_tpu import renderer as jrend
    from yuki_tpu import sampling as jsam
    from yuki_tpu.scene.cornell import cornell as jcornell

    film_kw, rs, single = RENDERER_MODES[mode]
    scene, cam = scene_and_cam
    fs = FilmSettings(res=(64, 32), tile_dim=16, **film_kw)
    film, msgs = _render(scene, cam, fs, UniformSampler(2), PathParams(3),
                         rs, seed=11, force_single=single)

    jscene, jcam, _ = jcornell()
    jfs = jfilm.FilmSettings(res=(64, 32), tile_dim=16, **film_kw)
    jf = jfilm.film_or_new(None, jfs)
    r = jrend.Renderer()
    r.launch(jscene, jcam, jf, jsam.UniformSampler(2), jintg.PathParams(3),
             jfs, jrend.RenderSettings(**dataclasses.asdict(rs)),
             force_single_sample_flag=single, match_seed=11)
    jmsgs = run_to_completion(r)
    r.kill()
    assert isinstance(jmsgs[-1], jrend.RenderFinished), jmsgs[-1]

    same_bits(film.samples.numpy(), np.asarray(jf.samples))
    assert (film.samples.numpy() == (2 if fs.accumulate else 1)).all()
    spp = 1 if single else 2
    for got, ref in ((film.raw_sums(), jf.raw_sums()),
                     (film.image(), jf.image())):
        tp.assert_parity(ref, jmsgs[-1].ray_count, got, msgs[-1].ray_count,
                         3, spp=spp)


def test_kill_cancels(scene_and_cam):
    scene, cam = scene_and_cam
    fs = FilmSettings(res=(128, 96), tile_dim=16)
    film = film_or_new(None, fs, device="cpu")
    r = Renderer()
    r.launch(scene, cam, film, UniformSampler(8), PathParams(3), fs,
             RenderSettings(wave_tiles=1))
    time.sleep(0.2)
    r.kill()
    assert not r.is_active()
    assert not any(isinstance(m, RenderFinished) for m in r.check_status())
    assert int(film.samples.sum()) < film.n_tiles


def test_stale_render_filtered(scene_and_cam):
    scene, cam = scene_and_cam
    fs = FilmSettings(res=(32, 32), tile_dim=16)
    film = film_or_new(None, fs, device="cpu")
    r = Renderer()
    r.launch(scene, cam, film, UniformSampler(1), PathParams(1), fs)
    rid2 = r.launch(scene, cam, film, UniformSampler(1), PathParams(1), fs)
    msgs = run_to_completion(r)
    r.kill()
    assert msgs and all(m.render_id == rid2 for m in msgs)


def test_error_reaches_caller(scene_and_cam):
    """A failure in the manager thread arrives as a RenderError naming it
    (here an integrator name that names none)."""
    scene, cam = scene_and_cam
    fs = FilmSettings(res=(32, 32), tile_dim=16)
    r = Renderer()
    r.launch(scene, cam, film_or_new(None, fs, device="cpu"),
             UniformSampler(1), "no_such_view", fs)
    msgs = run_to_completion(r)
    r.kill()
    assert isinstance(msgs[-1], RenderError)
    assert "ValueError" in msgs[-1].message
    assert "no_such_view" in msgs[-1].message


def test_deterministic_across_wave_sizes(scene_and_cam):
    scene, cam = scene_and_cam
    fs = FilmSettings(res=(64, 48), tile_dim=16)
    imgs = [_render(scene, cam, fs, UniformSampler(2), PathParams(2),
                    RenderSettings(wave_tiles=w), seed=42)[0].image()
            for w in (3, 12)]
    same_bits(imgs[0], imgs[1])


def test_samples_per_launch(scene_and_cam):
    """A samples_per_launch=2 render gives the per-sample loop's film to
    1e-6 (the launch sum adds two samples before the wave's sum does)."""
    scene, cam = scene_and_cam
    fs = FilmSettings(res=(32, 32), tile_dim=16)
    imgs = [_render(scene, cam, fs, UniformSampler(4), PathParams(2),
                    RenderSettings(wave_tiles=2, samples_per_launch=spl),
                    seed=3)[0].image() for spl in (1, 2)]
    np.testing.assert_allclose(imgs[0], imgs[1], atol=1e-6)


@pytest.mark.parametrize("sampler", [UniformSampler(2),
                                     StratifiedSampler(2, 1)],
                         ids=["uniform", "stratified"])
def test_renderer_film_equals_render_frame(scene_and_cam, sampler):
    scene, cam = scene_and_cam
    fs = FilmSettings(res=(64, 48), tile_dim=16)
    film, msgs = _render(scene, cam, fs, sampler, PathParams(3),
                         RenderSettings(wave_tiles=5), seed=9)
    ref = render_frame(scene, cam, fs, sampler, PathParams(3),
                       wave_tiles=5, seed=9)
    same_bits(film.tiles_buf.numpy(), ref.film.tiles_buf.numpy())
    same_bits(film.samples.numpy(), ref.film.samples.numpy())
    assert msgs[-1].ray_count == ref.ray_count


def test_pass_scope_names():
    """Every pass_scope range in the port is one of profiling.SCOPES, the
    names that chip_smoke.py and chip_ab.py leave out of device busy time;
    any other name raises."""
    import re

    from yuki_tpu_torch import profiling

    used = {m for f in (REPO / "yuki_tpu_torch").rglob("*.py")
            for m in re.findall(r'pass_scope\("([^"]+)"\)', f.read_text())}
    assert used == set(profiling.SCOPES)
    with pytest.raises(ValueError, match="SCOPES"):
        profiling.pass_scope("trace.renamed")


# --- command line -----------------------------------------------------------


def _cli(tmp_path, *args, importtime=False):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, *(["-X", "importtime"] if importtime else []),
         "-m", "yuki_tpu_torch", *args],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)


def test_cli_renders_the_in_process_image(tmp_path):
    from yuki_tpu_torch.app.exr import read_exr
    from yuki_tpu_torch.app.settings import load_settings, save_settings
    from yuki_tpu_torch.app.util import try_load_scene
    from yuki_tpu_torch.tonemap import FilmicParams, filmic

    s = load_settings(None)
    s = dataclasses.replace(
        s, film_settings=FilmSettings(res=(64, 48), tile_dim=16),
        sampler=StratifiedSampler(2, 1), integrator=PathParams(2),
        render_settings=RenderSettings(wave_tiles=5))
    save_settings(s, str(tmp_path / "s.yaml"))
    scene_file = str(REPO / "scenes" / "cornell.pbrt")
    out = tmp_path / "out.exr"
    res = _cli(tmp_path, "--device", "cpu", f"--scene={scene_file}",
               "--settings=s.yaml", f"--out={out}", importtime=True)
    assert res.returncode == 0, res.stderr[-3000:]
    imported = {line.split("|")[-1].strip()
                for line in res.stderr.splitlines()
                if line.startswith("import time:")}
    assert "yuki_tpu_torch.app.headless" in imported
    assert not {m for m in imported if m.split(".")[0] in ("jax",
                                                            "yuki_tpu")}
    assert (tmp_path / "yuki.log").exists()

    s.load_settings.path = scene_file
    scene, cam, _, _ = try_load_scene(s.load_settings, device="cpu")
    film, _ = _render(scene, cam, s.film_settings, s.sampler, s.integrator,
                      s.render_settings)
    same_bits(read_exr(str(out)),
              filmic(film.image_device(), FilmicParams()).numpy())


@pytest.mark.parametrize("args,names", [
    (("--view", "--scene=x.obj"),
     ("ValueError", "unknown scene extension", ".obj")),
], ids=["view"])
def test_cli_names_what_is_missing(tmp_path, args, names):
    """The CLI exits non-zero naming what it lacks: the viewer (no --out)
    loads its scene before it serves, so a scene file of a format no
    loader reads fails at once."""
    res = _cli(tmp_path, "--device", "cpu", *args)
    assert res.returncode != 0
    for name in names:
        assert name in res.stderr, res.stderr[-3000:]
    assert "viewer on http://" not in res.stdout
