"""The treelet path's shading step (yuki_tpu_torch.ops.shade_fused:
shade_fused, resolve_fused) against yuki_tpu's functions of the same names.
On the CPU the port's wrappers run the plain versions; the CUDA kernels
are held against those on the card (test_torch_cuda_treelet.py,
chip_smoke.py).

Both sides get the same inputs: the bridged scene tables, one bounce of
camera-ray hits found by yuki_tpu's traversal, and the same beta, liveness
and sampler keys.  yuki_tpu's shade kernel body runs op by op
(torch_parity.eager_pallas): in Pallas interpret mode XLA compiles it and
contracts FMAs, which moves small, cancelling components by a few ulps
(measured: 2 of 2304 next-direction components outside rtol 2e-6 / atol
1e-7).  With cos/sin/log evaluated by XLA on both sides the outputs agree
to that tolerance (measured: exactly); flags, skip ids and the resolve
agree exactly.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from yuki_tpu import traverse as jtraverse
from yuki_tpu.camera import Camera as JCamera
from yuki_tpu.ops import shade_fused as jsf
from yuki_tpu.sampling import SampleCtx as JSampleCtx
from yuki_tpu.sampling import UniformSampler as JUniform
from yuki_tpu_torch import integrators as tintg
from yuki_tpu_torch.integrators import PathParams
from yuki_tpu_torch.ops import shade_fused as tsf
from yuki_tpu_torch.sampling import SampleCtx
from yuki_tpu_torch.traverse import SceneHit

torch.set_num_threads(2)

N = 768  # the 12 8x8 tiles of the 64x48 film
NAMES = ("o2", "d2", "beta2", "alive2", "spec2", "no", "nd", "nt",
         "ns_skip", "nw", "nc", "ne")
EXACT = ("alive2", "spec2", "ns_skip", "nw")


def _xla(fn):
    return lambda x: torch.as_tensor(np.array(fn(x.numpy())))


@pytest.fixture
def xla_transcendentals(monkeypatch):
    monkeypatch.setattr(tsf, "_cos", _xla(jnp.cos))
    monkeypatch.setattr(tsf, "_sin", _xla(jnp.sin))
    monkeypatch.setattr(tsf, "_log", _xla(jnp.log))


def _bounce_inputs(name, seed):
    """One bounce's inputs for both sides: camera rays through the wave's
    pixels, their hits (yuki_tpu's traversal), random beta and specular
    flags, and the sampler keys."""
    jscene, cam = tp.jax_scene(name)
    camera = JCamera.create(cam, *tp.RES)
    iy, ix = np.meshgrid(np.arange(tp.TD), np.arange(tp.TD), indexing="ij")
    px = (tp.ORIGINS[:, 0, None, None] + ix[None]).reshape(-1).astype(np.int32)
    py = (tp.ORIGINS[:, 1, None, None] + iy[None]).reshape(-1).astype(np.int32)
    rng = np.random.default_rng(seed)
    p_film = np.stack([px, py], -1).astype(np.float32) + rng.random((N, 2),
                                                                    np.float32)
    o, d = camera.ray(jnp.asarray(p_film))
    hit = jtraverse.intersect(jscene.data, jscene.meta, o, d,
                              jnp.full(N, jtraverse.F32_MAX))
    beta = (rng.random((N, 3)) + 0.2).astype(np.float32)
    spec = rng.random(N) < 0.3
    return jscene, dict(o=np.array(o), d=np.array(d), beta=beta,
                        spec=spec, px=px, py=py,
                        hit={k: np.array(v) for k, v in hit._asdict().items()})


def _run_both(name, bounce, sample_index=3, seed=11):
    jscene, x = _bounce_inputs(name, seed)
    n_lights = len(jscene.meta.light_types)
    dim0 = 2 + bounce * (2 * n_lights + 3)
    hit = x["hit"]
    alive = hit["hit"]
    jctx = JSampleCtx(px=jnp.asarray(x["px"]), py=jnp.asarray(x["py"]),
                      sample_index=jnp.uint32(sample_index),
                      seed=jnp.uint32(seed))
    with tp.eager_pallas():
        ref = jsf.shade_fused(
            jscene.data, jscene.meta, JUniform(1), jctx,
            jtraverse.SceneHit(**{k: jnp.asarray(v) for k, v in hit.items()}),
            jnp.asarray(x["o"]), jnp.asarray(x["d"]), jnp.asarray(x["beta"]),
            jnp.asarray(alive), jnp.asarray(x["spec"]), dim0, bounce,
            interpret=True,
        )
    tscene = tp.bridged(jscene)
    tables = tsf.make_shade_tables(tscene, PathParams(5))
    ctx = SampleCtx(px=torch.as_tensor(x["px"]), py=torch.as_tensor(x["py"]),
                    sample_index=sample_index, seed=seed)
    got = tsf.shade_fused(
        tables, SceneHit(**{k: torch.as_tensor(v) for k, v in hit.items()}),
        torch.as_tensor(x["o"]), torch.as_tensor(x["d"]),
        torch.as_tensor(x["beta"]), torch.as_tensor(alive),
        torch.as_tensor(x["spec"]), tintg._ph_i32(ctx), dim0, bounce,
    )
    return {k: np.asarray(v) for k, v in zip(NAMES, ref)}, {
        k: v.numpy() for k, v in zip(NAMES, got)}


@pytest.mark.parametrize("name,bounce", [("reduced", 0), ("reduced", 2),
                                         ("textured-treelet", 0),
                                         ("textured-treelet", 4)])
def test_shade_fused_matches_jax(name, bounce, xla_transcendentals):
    ref, got = _run_both(name, bounce)
    assert got["alive2"].sum() > 50
    for k in NAMES:
        assert got[k].shape == ref[k].shape, k
        if k in EXACT:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], ref[k], rtol=2e-6, atol=1e-7,
                                       err_msg=k)


def test_shade_planes_rect_skip_ids():
    """The rect light's shadow rays skip its own triangles (its light id);
    the distant light's skip nothing (-2)."""
    _, got = _run_both("reduced", 0)
    assert set(got["ns_skip"][:N].tolist()) == {0}
    assert set(got["ns_skip"][N:].tolist()) == {-2}


@pytest.mark.parametrize("n_lights", [1, 2])
@pytest.mark.parametrize("clamp", [None, 0.5])
@pytest.mark.parametrize("bounce", [0, 2])
def test_resolve_fused_matches_jax(n_lights, clamp, bounce):
    jscene, _ = tp.jax_scene("reduced")
    rng = np.random.default_rng(n_lights * 10 + bounce)
    n = 300  # not a whole block: yuki_tpu pads, the port does not need to
    x = dict(
        radiance=rng.random((n, 3)).astype(np.float32),
        beta=(rng.random((n, 3)) * 2).astype(np.float32),
        alive=rng.random(n) < 0.7, missed=rng.random(n) < 0.2,
        ne=(rng.random((n, 3)) * 0.3).astype(np.float32),
        occ=rng.random(n_lights * n) < 0.4,
        worth=rng.random(n_lights * n) < 0.8,
        contrib=(rng.random((n_lights * n, 3)) * 1.5).astype(np.float32),
    )
    with tp.eager_pallas():
        ref = jsf.resolve_fused(
            jscene.data, *(jnp.asarray(x[k]) for k in (
                "radiance", "beta", "alive", "missed", "ne", "occ", "worth",
                "contrib")), bounce, n_lights, clamp, interpret=True)
    tables = tsf.make_shade_tables(tp.bridged(jscene),
                                   PathParams(5, indirect_clamp=clamp))
    tables = dataclasses.replace(tables, light_types=(2, 3)[:n_lights])
    got = tsf.resolve_fused(tables, *(torch.as_tensor(x[k]) for k in (
        "radiance", "beta", "alive", "missed", "ne", "occ", "worth",
        "contrib")), bounce)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_gate():
    from yuki_tpu_torch.sampling import StratifiedSampler, UniformSampler

    tscene, _ = tp.port_scene("reduced")
    assert tsf.fused_shade_supported(tscene.meta, UniformSampler(1))
    assert tsf.fused_shade_supported(tscene.meta, StratifiedSampler(2, 2))
    assert not tsf.fused_shade_supported(tscene.meta, "whitted")
    textured_sphere = dataclasses.replace(tscene.meta,
                                          sphere_mats_untextured=False)
    assert not tsf.fused_shade_supported(textured_sphere, UniformSampler(1))


def test_cpu_path_counts_no_launches():
    tsf.reset_launches()
    _run_both("reduced", 1)
    assert tsf.LAUNCHES == {"shade": 0, "resolve": 0}
