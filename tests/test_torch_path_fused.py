"""The port's dense path-tracing wave (yuki_tpu_torch.ops.path_fused) held
against the JAX package, kernel by kernel.

Here on the CPU the wrappers run their plain PyTorch versions; the JAX
side is path_fused's own kernel bodies (_raygen_values, _bounce_values)
called on plain arrays in place of refs, with the tables built by the
JAX package's helpers and the port's from the bridged scene.  The CUDA
kernels themselves are checked against these plain versions on the card
(test_torch_cuda.py, chip_smoke.py).
"""

import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from yuki_tpu.camera import Camera as JCamera
from yuki_tpu.ops import path_fused as jpf
from yuki_tpu_torch.camera import Camera
from yuki_tpu_torch.integrators import PathParams
from yuki_tpu_torch.ops import path_fused as tpf
from yuki_tpu_torch.ops import shade_fused as tsf
from yuki_tpu_torch.renderer import make_wave_renderer, render_frame
from yuki_tpu_torch.sampling import UniformSampler

torch.set_num_threads(2)

N = 1024  # one (8, 128) block of the JAX bodies
MAX_DEPTH = 5
GOLDEN = Path(__file__).parent / "goldens" / "cornell_64x48_path4_8spp_seed42.npz"
REPO = Path(__file__).resolve().parents[1]


def _i32(x: int):
    return jnp.int32(np.uint32(x & 0xFFFFFFFF).view(np.int32))


def _pixels(seed: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, tp.RES[0], N).astype(np.int32),
            rng.integers(0, tp.RES[1], N).astype(np.int32))


@lru_cache(maxsize=None)
def _setup(name: str, clamp=None):
    """JAX scene + tables, and the port's tables from the bridged scene."""
    jscene, cam = tp.jax_scene(name)
    jt = tp.jax_wave_tables(jscene, JCamera.create(cam, *tp.RES), clamp)
    tscene = tp.bridged(jscene)
    tb = tpf.make_tables(tscene, Camera.create(cam, *tp.RES),
                         PathParams(MAX_DEPTH, indirect_clamp=clamp))
    return jscene, jt, tb


def _jax_raygen(jt, px, py, sample_index, seed):
    s = jt["statics"]
    return jpf._raygen_values(
        jnp.asarray(px.reshape(8, 128)), jnp.asarray(py.reshape(8, 128)),
        _i32(sample_index), _i32(seed), jt["ms"], jt["tri"], jt["sp"],
        n_tris=s["n_tris"], n_spheres=s["n_spheres"],
    )


def _jax_bounce(jt, stv, ph, b):
    s = jt["statics"]
    return jpf._bounce_values(
        jnp.int32(2 + b * (2 * s["n_lights"] + 3)), jnp.int32(b),
        lambda k: stv[k], ph, jt["ms"], jt["tri"], jt["trs"], jt["trb"],
        jt["matb"], jt["lt"], jt["sp"], jt["td"], jt["tex"], jt["pal"],
        max_depth=MAX_DEPTH, **s,
    )


def _bounce_dict(out):
    o2, d2, beta2, rad, alive2, spec2, rc2 = out
    return dict(
        ox=o2[0], oy=o2[1], oz=o2[2], dx=d2[0], dy=d2[1], dz=d2[2],
        bx=beta2[0], by=beta2[1], bz=beta2[2],
        rx=rad[0], ry=rad[1], rz=rad[2],
        alive=alive2.astype(jnp.float32), spec=spec2.astype(jnp.float32),
        rc=rc2,
    )


def _to_state(stv) -> torch.Tensor:
    zero = np.zeros(N, np.float32)
    return torch.as_tensor(np.stack([
        np.asarray(stv[k]).reshape(-1) if k in stv else zero
        for k in tpf._ST
    ]))


@lru_cache(maxsize=None)
def _jax_states(name: str, clamp=None):
    """JAX wave state entering bounces 0..2 of one 1024-ray block, each
    with JAX's own bounce output, chained through path_fused's trace."""
    jscene, jt, _ = _setup(name, clamp)
    s = jt["statics"]
    px, py = _pixels(11)
    ph, stv = _jax_raygen(jt, px, py, 3, 2 ** 31 + 7)
    states = []
    for b in range(3):
        out = _bounce_dict(_jax_bounce(jt, stv, ph, b))
        states.append((dict(stv), out))
        alive2 = out["alive"] > 0.0
        t, prim, b0, b1, sph, hitf = jpf._trace_scene(
            jt["tri"], jt["sp"], s["n_tris"], s["n_spheres"],
            (out["ox"], out["oy"], out["oz"]),
            (out["dx"], out["dy"], out["dz"]),
            jnp.where(alive2, 3.4028235e38, 0.0),
        )
        stv = dict(out, t=t, b0=b0, b1=b1, prim=prim, sph=sph, hitf=hitf)
    return torch.as_tensor(np.array(ph).reshape(-1)), states


def _xla(fn):
    """A transcendental evaluated by XLA on the CPU, as the JAX body does."""
    return lambda x: torch.as_tensor(np.array(fn(x.numpy())))


@pytest.fixture
def xla_transcendentals(monkeypatch):
    monkeypatch.setattr(tsf, "_cos", _xla(jnp.cos))
    monkeypatch.setattr(tsf, "_sin", _xla(jnp.sin))
    monkeypatch.setattr(tsf, "_log", _xla(jnp.log))


# --------------------------------------------------------------------
# raygen_trace
# --------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cornell", "pointspot", "midsize"])
def test_raygen_matches_jax(name):
    """prim, sph, hitf and the sampler hash are exact; the float planes
    agree to rtol 1e-6 (XLA's eager camera chain differs by an ulp on a
    lane or two in a thousand).  Past 64 triangles JAX sweeps in a
    compiled fori_loop, where XLA's CPU backend contracts the edge
    functions' a*b - c*d into FMAs (the port and the CUDA kernel do not,
    like JAX's unrolled sweep); the barycentrics, ratios of those
    cancelling terms, then differ by up to ~4e-5 relative on a few
    lanes, so that scene's t/b0/b1 get rtol 1e-4."""
    _, jt, tb = _setup(name)
    hit_tol = dict(rtol=1e-4, atol=1e-5) if name == "midsize" else {}
    px, py = _pixels(0)
    for sample_index, seed in [(0, 7), (5, 2 ** 31 + 3), (2 ** 32 - 1, 42)]:
        ph_ref, stv = _jax_raygen(jt, px, py, sample_index, seed)
        st, ph = tpf.raygen_trace(torch.as_tensor(px), torch.as_tensor(py),
                                  sample_index, seed, tb)
        np.testing.assert_array_equal(ph.numpy(),
                                      np.asarray(ph_ref).reshape(-1))
        for k in ("prim", "sph", "hitf", "bx", "alive", "rc", "rx"):
            np.testing.assert_array_equal(
                st[tpf._ST[k]].numpy(), np.asarray(stv[k]).reshape(-1), k)
        for k in ("ox", "oy", "oz", "dx", "dy", "dz", "t", "b0", "b1"):
            tol = dict(rtol=1e-6, atol=1e-7)
            if k in ("t", "b0", "b1"):
                tol.update(hit_tol)
            np.testing.assert_allclose(
                st[tpf._ST[k]].numpy(), np.asarray(stv[k]).reshape(-1),
                err_msg=k, **tol)
        assert st[tpf._ST["hitf"]].sum() > N // 2  # rays do hit the scene


# --------------------------------------------------------------------
# bounce
# --------------------------------------------------------------------

BOUNCE_CASES = [("cornell", None), ("pointspot", None), ("midsize", None),
                ("cornell", 2.0)]
# (scene, clamp, bounce).  The point/spot scene is one plane under two
# lights: every ray leaves it after bounce 0, so later bounces shade
# nothing there.
BOUNCES = [("cornell", None, 0), ("cornell", None, 2),
           ("pointspot", None, 0), ("midsize", None, 0),
           ("midsize", None, 2), ("cornell", 2.0, 0), ("cornell", 2.0, 2)]
EXACT = ("alive", "spec", "rc")
CLOSE = ("ox", "oy", "oz", "dx", "dy", "dz", "bx", "by", "bz",
         "rx", "ry", "rz")


def _port_bounce(name, clamp, b):
    _, _, tb = _setup(name, clamp)
    ph, states = _jax_states(name, clamp)
    stv, ref = states[b]
    shaded = (np.asarray(stv["alive"]) > 0) & (np.asarray(stv["hitf"]) > 0)
    assert shaded.sum() >= N // 32, "bounce would shade too few lanes"
    return tpf.bounce(_to_state(stv), ph, b, tb), ref


@pytest.mark.parametrize("name,clamp,bounce_index", BOUNCES)
def test_bounce_matches_jax(name, clamp, bounce_index, xla_transcendentals):
    """One bounce from the same JAX state, with cos/sin/log evaluated by
    XLA on both sides: radiance, beta and the next ray agree to rtol 2e-6
    / atol 1e-7, liveness, specular flag and ray count exactly."""
    out, ref = _port_bounce(name, clamp, bounce_index)
    for k in EXACT:
        np.testing.assert_array_equal(out[tpf._ST[k]].numpy(),
                                      np.asarray(ref[k]).reshape(-1), k)
    for k in CLOSE:
        np.testing.assert_allclose(out[tpf._ST[k]].numpy(),
                                   np.asarray(ref[k]).reshape(-1),
                                   rtol=2e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name,clamp", BOUNCE_CASES)
def test_bounce_torch_transcendentals(name, clamp):
    """The same bounces with torch's own cos/sin/log: an ulp of cos or
    sin in the hemisphere and GGX warps moves a direction by up to ~1e-6
    near grazing angles, so a few lanes leave the 2e-6 band; all stay
    within 1e-4 + 1e-4|ref| and no lane changes liveness."""
    for _, _, b in [c for c in BOUNCES if c[:2] == (name, clamp)]:
        out, ref = _port_bounce(name, clamp, b)
        for k in EXACT:
            np.testing.assert_array_equal(out[tpf._ST[k]].numpy(),
                                          np.asarray(ref[k]).reshape(-1), k)
        for k in CLOSE:
            got = out[tpf._ST[k]].numpy()
            want = np.asarray(ref[k]).reshape(-1)
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                       err_msg=k)
            off = ~np.isclose(got, want, rtol=2e-6, atol=1e-7)
            assert off.mean() <= 0.1, f"{k}: {off.sum()} lanes off"


def test_bounce_next_hit_matches_jax(xla_transcendentals):
    """The bounce's next-ray trace agrees with JAX's _trace_scene on the
    JAX next ray (Cornell, bounce 0): hit ids on all but edge-grazing
    lanes, distances to rounding."""
    name = "cornell"
    _, states = _jax_states(name)
    out, _ = _port_bounce(name, None, 0)
    nxt = states[1][0]
    same = np.ones(N, bool)
    for k in ("prim", "sph", "hitf"):
        same &= out[tpf._ST[k]].numpy() == np.asarray(nxt[k]).reshape(-1)
    assert same.mean() >= 0.995
    np.testing.assert_allclose(out[tpf._ST["t"]].numpy()[same],
                               np.asarray(nxt["t"]).reshape(-1)[same],
                               rtol=1e-5, atol=1e-6)


def test_last_bounce_writes_no_hit():
    """Past the last bounce nothing is traced (path.rs never traces
    there): the hit planes hold the no-hit values and rc stops."""
    _, _, tb = _setup("cornell")
    px, py = _pixels(1)
    st, ph = tpf.raygen_trace(torch.as_tensor(px), torch.as_tensor(py), 0,
                              1, tb)
    out = tpf.bounce(st, ph, MAX_DEPTH - 1, tb)
    for k, v in (("t", 0.0), ("prim", -1.0), ("sph", -1.0), ("hitf", 0.0)):
        assert torch.all(out[tpf._ST[k]] == v), k
    torch.testing.assert_close(out[tpf._ST["rc"]], st[tpf._ST["rc"]])


# --------------------------------------------------------------------
# golden, gate, launch counts, import hygiene
# --------------------------------------------------------------------


def test_golden_cornell_path4():
    """The port at 64x48, depth 4, 8 spp, seed 42 against the committed
    golden (rendered by yuki_tpu's XLA path_li chain), under the deep
    bounds of _assert_parity: the golden is the JAX-free tie to the
    reference that chip_smoke.py also checks on the card."""
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.scene.cornell import cornell

    scene, cam, _ = cornell(device="cpu")
    res = render_frame(scene, cam, FilmSettings(res=tp.RES, tile_dim=16),
                       UniformSampler(8), PathParams(4), wave_tiles=12,
                       samples_per_launch=8, seed=42)
    gold = np.load(GOLDEN)["img"]
    img = res.film.image()
    assert img.shape == gold.shape and np.isfinite(img).all()
    tp.assert_parity(gold, None, img, None, depth=4, spp=8)


def test_render_frame_wave_split_and_spl_bitwise():
    """Lanes are independent and samples add in sample order, so the frame
    is bit-identical however the tiles are cut into waves (the last one
    padded, its padding dropped by the film) and however many samples go
    into one launch.  Padding tiles are traced and their rays counted, as
    yuki_tpu's renderer and bench.py count them, so the ray count grows
    only when a wave is padded."""
    from yuki_tpu_torch.film import FilmSettings

    scene, cam = tp.port_scene("cornell")
    fs = FilmSettings(res=(40, 24), tile_dim=8)  # 15 tiles

    def frame(wave_tiles, spl):
        res = render_frame(scene, cam, fs, UniformSampler(2), PathParams(3),
                           wave_tiles=wave_tiles, samples_per_launch=spl,
                           seed=5)
        return res.film.image(), res.ray_count

    ref, rays = frame(15, 1)
    assert rays > 40 * 24 * 2  # every pixel sample traced at least once
    for wave_tiles, spl in [(5, 1), (15, 2), (4, 1), (7, 2)]:
        img, n = frame(wave_tiles, spl)
        np.testing.assert_array_equal(img, ref)
        assert n == rays if 15 % wave_tiles == 0 else n > rays


def test_gate_rejects_loudly():
    from yuki_tpu_torch import transforms as tf
    from yuki_tpu_torch.sampling import StratifiedSampler
    from yuki_tpu_torch.scene.data import SceneBuilder

    scene, cam = tp.port_scene("cornell")
    camera = Camera.create(cam, *tp.RES)
    assert tpf.wave_supported(scene.meta, UniformSampler(1))
    # The stratified sampler is accepted: the wave reads its planes.
    assert tpf.wave_supported(scene.meta, StratifiedSampler(2, 2))
    px, rays = make_wave_renderer(scene, camera, StratifiedSampler(2, 2),
                                  PathParams(2), tp.TD, tp.TILES)(
        tp.ORIGINS[:1], 0, 0)
    assert px.shape == (1, tp.TD, tp.TD, 3) and torch.isfinite(px).all()
    with pytest.raises(NotImplementedError, match="PathParams"):
        make_wave_renderer(scene, camera, UniformSampler(1), "whitted",
                           tp.TD, tp.TILES)

    # Past the 1024-triangle wave gate (a dense scene by SceneBuilder's
    # rule, but the fused wave refuses it, as yuki_tpu's does): the
    # renderer builds the path_li route over the dense sweeps instead.
    n = tpf.MAX_TRIS_WAVE + 1
    b = SceneBuilder("past-gate")
    pts = np.random.default_rng(0).random((3 * n, 3)).astype(np.float32)
    b.add_mesh(tf.Transform.identity(), np.arange(3 * n), pts)
    b.add_point_light(tf.translation((0, 2, 0)), (1.0, 1.0, 1.0))
    big = b.build(device="cpu")
    assert not tpf.wave_supported(big.meta, UniformSampler(1))
    px, rays = make_wave_renderer(big, camera, UniformSampler(1),
                                  PathParams(2), tp.TD, tp.TILES)(
        tp.ORIGINS[:1], 0, 0)
    assert px.shape == (1, tp.TD, tp.TD, 3) and torch.isfinite(px).all()
    assert float(rays) >= tp.TD * tp.TD


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the request is valid here")
    from yuki_tpu_torch.scene.cornell import cornell

    with pytest.raises(RuntimeError, match="cuda"):
        cornell(device="cuda")


def test_cpu_path_counts_no_launches():
    """The counters count kernel launches only; the CPU runs the plain
    versions."""
    _, _, tb = _setup("pointspot")
    tpf.reset_launches()
    px, py = _pixels(2)
    tpf.path_li_wave(tb, torch.as_tensor(px), torch.as_tensor(py), 0, 0)
    assert tpf.LAUNCHES == {"raygen_trace": 0, "bounce": 0, "wave": 0}


def test_import_hygiene():
    """Importing every module of the port loads no JAX and no yuki_tpu:
    the machine with the card has no JAX."""
    pkg = REPO / "yuki_tpu_torch"
    mods = []
    for p in sorted(pkg.rglob("*.py")):
        parts = p.relative_to(REPO).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or m == 'yuki_tpu' "
        "or m.startswith('yuki_tpu.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(mods) >= 15
