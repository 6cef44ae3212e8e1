"""The shading chain's modules (surface, bsdf, lights) against eager
yuki_tpu on the CPU, on the same hits: rays from a numpy seed on Cornell
(textured wall, glass box, copper sphere, rect light), pointspot (point and
spot lights, sigma matte), midsize (metal sphere, rect light) and
sun-sphere (textured sphere, glass box, distant and point lights), their
closest hits by the port's query.  yuki_tpu runs under jax.disable_jit(),
op by op, where XLA contracts no FMA.

With the transcendentals (atan2, acos, sin in the sphere uv; log in
roughness_to_alpha; cos, sin in the hemisphere and GGX warps) evaluated
by XLA on both sides (``xla_transcendentals``) every output is equal bit
for bit.  With torch's own, the tests state the measured ulp bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from yuki_tpu import bsdf as jbsdf
from yuki_tpu import lights as jlights
from yuki_tpu import surface as jsurface
from yuki_tpu import traverse as jtr
from yuki_tpu.sampling import SampleCtx as JSampleCtx
from yuki_tpu.sampling import UniformSampler as JUniform
from yuki_tpu_torch import bsdf as tbsdf
from yuki_tpu_torch import lights as tlights
from yuki_tpu_torch import sampling as tsampling
from yuki_tpu_torch import surface as tsurface
from yuki_tpu_torch.sampling import SampleCtx, UniformSampler
from yuki_tpu_torch.surface import Surface
from yuki_tpu_torch.traverse import SceneHit

torch.set_num_threads(2)

SCENES = ["cornell", "pointspot", "midsize", "sun-sphere"]


@pytest.fixture
def xla_transcendentals(monkeypatch):
    monkeypatch.setattr(tsurface, "_atan2", tp.xla_fn(jnp.arctan2))
    monkeypatch.setattr(tsurface, "_acos", tp.xla_fn(jnp.arccos))
    monkeypatch.setattr(tsurface, "_sin", tp.xla_fn(jnp.sin))
    monkeypatch.setattr(tbsdf, "_log", tp.xla_fn(jnp.log))
    monkeypatch.setattr(tbsdf, "_cos", tp.xla_fn(jnp.cos))
    monkeypatch.setattr(tbsdf, "_sin", tp.xla_fn(jnp.sin))
    monkeypatch.setattr(tsampling, "_cos", tp.xla_fn(jnp.cos))
    monkeypatch.setattr(tsampling, "_sin", tp.xla_fn(jnp.sin))


_CACHE = {}


def _inputs(name):
    """(jscene, tscene, o, d, hit, si, mp, u): the chain's inputs, the
    port's surface and materials (fed to both sides downstream), and
    uniform draws from a numpy seed."""
    if name not in _CACHE:
        jscene, tscene, o, d, hit = tp.chain_inputs(name)
        si = tsurface.make_surface(tscene.data, SceneHit(**hit), o, d)
        mp = tbsdf.gather_materials(tscene.data, si, tscene.meta)
        u = torch.as_tensor(np.random.default_rng(9).random(
            (o.shape[0], 2), np.float32))
        _CACHE[name] = (jscene, tscene, o, d, hit, si, mp, u)
    return _CACHE[name]


def _eq(got, want, what):
    """Equal bit for bit (signed zeros compare equal, as in IEEE)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


def _jsurface(si: Surface):
    return jsurface.Surface(*(tp.to_jnp(v) for v in si))


def _jmp(mp):
    return jbsdf.MatParams(*(tp.to_jnp(v) for v in mp))


def _surfaces(name):
    jscene, tscene, o, d, hit, *_ = _inputs(name)
    with jax.disable_jit():
        ref = jsurface.make_surface(jscene.data, jtr.SceneHit(
            **tp.to_jnp(hit)), tp.to_jnp(o), tp.to_jnp(d))
    got = tsurface.make_surface(tscene.data, SceneHit(**hit), o, d)
    return ref, got, hit


@pytest.mark.parametrize("name", SCENES)
def test_make_surface_matches_jax(name, xla_transcendentals):
    ref, got, hit = _surfaces(name)
    assert hit["hit"].float().mean() > 0.3
    for k in Surface._fields:
        _eq(getattr(got, k), getattr(ref, k), k)


@pytest.mark.parametrize("name", ["cornell", "midsize", "sun-sphere"])
def test_make_surface_torch_transcendentals(name):
    """Triangle lanes are equal bit for bit.  On sphere lanes p and ss
    take no transcendental and are equal; torch's own atan2 and acos move
    uv, its sin the normals n and ns, by at most 2.5e-7 (measured: 2.1e-7
    on Cornell's copper sphere, two ulps of 1.0)."""
    ref, got, hit = _surfaces(name)
    sph = hit["sphere"].numpy() >= 0
    assert sph.any()
    for k in Surface._fields:
        g = getattr(got, k).numpy()
        r = np.asarray(getattr(ref, k))
        _eq(g[~sph], r[~sph], k)
        if k in ("n", "ns", "uv"):
            np.testing.assert_allclose(g[sph], r[sph], rtol=0, atol=2.5e-7,
                                       err_msg=k)
        else:
            _eq(g[sph], r[sph], k)


@pytest.mark.parametrize("name", SCENES)
def test_gather_materials_matches_jax(name, xla_transcendentals):
    jscene, tscene, _, _, _, si, _, _ = _inputs(name)
    with jax.disable_jit():
        ref = jbsdf.gather_materials(jscene.data, _jsurface(si), jscene.meta)
    got = tbsdf.gather_materials(tscene.data, si, tscene.meta)
    for k in tbsdf.MatParams._fields:
        _eq(getattr(got, k), getattr(ref, k), k)
    if name == "cornell":  # the textured back wall
        assert tscene.meta.has_textures


def test_roughness_to_alpha_torch_log():
    """torch's own log moves the remapped roughness by at most 1e-6
    absolute (measured 7.2e-7 over 4096 roughnesses in [0, 1): the fit's
    terms cancel to alpha 0.08 near roughness 0.003, 96 ulps there)."""
    r = torch.as_tensor(np.random.default_rng(1).random(4096, np.float32))
    with jax.disable_jit():
        ref = jbsdf.roughness_to_alpha(tp.to_jnp(r))
    np.testing.assert_allclose(tbsdf.roughness_to_alpha(r).numpy(), ref,
                               rtol=0, atol=1e-6)


def _light_dirs(name):
    """Each light's sample direction (the port's sample_li), the wi the
    NEE calls bsdf_f with."""
    _, tscene, *_, si, _, u = _inputs(name)
    return [tlights.sample_li(tscene.data, i, t, si, u).l
            for i, t in enumerate(tscene.meta.light_types)]


@pytest.mark.parametrize("name", SCENES)
def test_bsdf_f_matches_jax(name, xla_transcendentals):
    jscene, tscene, _, _, _, si, mp, _ = _inputs(name)
    for wi in _light_dirs(name):
        with jax.disable_jit():
            ref = jbsdf.bsdf_f(_jmp(mp), _jsurface(si), tp.to_jnp(si.wo),
                               tp.to_jnp(wi), jscene.meta)
        got = tbsdf.bsdf_f(mp, si, si.wo, wi, tscene.meta)
        _eq(got, ref, "f")
        assert (got.abs().sum(-1) > 0).float().mean() > 0.1


@pytest.mark.parametrize("name", SCENES)
def test_bsdf_sample_matches_jax(name, xla_transcendentals):
    jscene, tscene, _, _, _, si, mp, u = _inputs(name)
    with jax.disable_jit():
        ref = jbsdf.bsdf_sample(_jmp(mp), _jsurface(si), tp.to_jnp(si.wo),
                                tp.to_jnp(u), jscene.meta)
    got = tbsdf.bsdf_sample(mp, si, si.wo, u, tscene.meta)
    for k in tbsdf.BsdfSample._fields:
        _eq(getattr(got, k), getattr(ref, k), k)
    assert got.valid.float().mean() > 0.2


@pytest.mark.parametrize("name", ["cornell", "midsize", "sun-sphere"])
def test_bsdf_sample_torch_transcendentals(name):
    """Glass lanes (no warp) are equal bit for bit.  Elsewhere torch's own
    cos and sin (the hemisphere and GGX warps) move wi by at most 1e-6
    (measured 7.2e-7, six ulps of 1.0) and f and pdf by at most 2e-5
    relative (measured 1.1e-5: near grazing a cos term amplifies the
    direction's ulps); no lane changes its validity or lobe."""
    jscene, tscene, _, _, _, si, mp, u = _inputs(name)
    with jax.disable_jit():
        ref = jbsdf.bsdf_sample(_jmp(mp), _jsurface(si), tp.to_jnp(si.wo),
                                tp.to_jnp(u), jscene.meta)
    got = tbsdf.bsdf_sample(mp, si, si.wo, u, tscene.meta)
    glass = (mp.mtype == 1).numpy()
    for k in tbsdf.BsdfSample._fields:
        g, r = getattr(got, k).numpy(), np.asarray(getattr(ref, k))
        _eq(g[glass], r[glass], k)
    for k in ("valid", "is_specular", "is_transmission"):
        _eq(getattr(got, k), getattr(ref, k), k)
    np.testing.assert_allclose(got.wi.numpy(), ref.wi, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.f.numpy(), ref.f, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(got.pdf.numpy(), ref.pdf, rtol=2e-5,
                               atol=1e-7)


@pytest.mark.parametrize("name,transmission", [
    ("cornell", False), ("cornell", True), ("sun-sphere", False),
    ("sun-sphere", True)])
def test_bsdf_sample_specular_matches_jax(name, transmission):
    """Both specular lobes take no transcendental: equal bit for bit with
    torch's own maths, on lanes that hit glass from either side."""
    jscene, tscene, _, _, _, si, mp, _ = _inputs(name)
    with jax.disable_jit():
        ref = jbsdf.bsdf_sample_specular(_jmp(mp), _jsurface(si),
                                         tp.to_jnp(si.wo), transmission)
    got = tbsdf.bsdf_sample_specular(mp, si, si.wo, transmission)
    for k in tbsdf.BsdfSample._fields:
        _eq(getattr(got, k), getattr(ref, k), k)
    assert got.valid.sum() > 10


@pytest.mark.parametrize("name", SCENES)
def test_sample_li_matches_jax(name):
    """Every light type (point, spot: pointspot; rect: cornell, midsize;
    distant and point: sun-sphere); no transcendental."""
    jscene, tscene, _, _, _, si, _, u = _inputs(name)
    for i, t in enumerate(tscene.meta.light_types):
        with jax.disable_jit():
            ref = jlights.sample_li(jscene.data, i, t, _jsurface(si),
                                    tp.to_jnp(u))
        got = tlights.sample_li(tscene.data, i, t, si, u)
        for k in tlights.LightSample._fields:
            _eq(getattr(got, k), np.broadcast_to(getattr(ref, k),
                                                 getattr(got, k).shape),
                f"light {i} type {t} {k}")


@pytest.mark.parametrize("name", ["cornell", "midsize"])
def test_area_light_radiance_matches_jax(name):
    jscene, tscene, _, d, _, si, _, _ = _inputs(name)
    with jax.disable_jit():
        ref = jlights.area_light_radiance(jscene.data, _jsurface(si),
                                          tp.to_jnp(-d))
    got = tlights.area_light_radiance(tscene.data, si, -d)
    _eq(got, ref, "le")
    if name == "cornell":  # rays see its ceiling light's front
        assert (got.sum(-1) > 0).any()


@pytest.mark.parametrize("name", SCENES)
def test_spawn_rays_match_jax(name):
    jscene, tscene, _, _, _, si, _, u = _inputs(name)
    wi = tbsdf.bsdf_sample(_inputs(name)[6], si, si.wo, u, tscene.meta).wi
    ls = tlights.sample_li(tscene.data, 0, tscene.meta.light_types[0], si, u)
    with jax.disable_jit():
        ref_o = jsurface.spawn_ray(_jsurface(si), tp.to_jnp(wi))
        ref_so, ref_sd = jsurface.spawn_ray_to(_jsurface(si),
                                               tp.to_jnp(ls.target))
    _eq(tsurface.spawn_ray(si, wi), ref_o, "spawn_ray")
    so, sd = tsurface.spawn_ray_to(si, ls.target)
    _eq(so, ref_so, "spawn_ray_to o")
    _eq(sd, ref_sd, "spawn_ray_to d")


def test_nee_setup_matches_jax(xla_transcendentals):
    """The chain's NEE batch on pointspot (two lights, light-major), the
    sampler's draws included."""
    from yuki_tpu import integrators as jintg
    from yuki_tpu_torch import integrators as tintg

    jscene, tscene, o, _, hit, si, mp, _ = _inputs("pointspot")
    n = o.shape[0]
    px = torch.arange(n, dtype=torch.int32) % 64
    py = torch.arange(n, dtype=torch.int32) // 64
    active = hit["hit"]
    with jax.disable_jit():
        ref = jintg._nee_setup(
            jscene.data, jscene.meta, JUniform(1),
            JSampleCtx(px=tp.to_jnp(px), py=tp.to_jnp(py),
                       sample_index=jnp.uint32(3), seed=jnp.uint32(7)),
            _jsurface(si), _jmp(mp), 2, tp.to_jnp(active))
    got = tintg._nee_setup(tscene.data, tscene.meta, UniformSampler(1),
                           SampleCtx(px=px, py=py, sample_index=3, seed=7),
                           si, mp, 2, active)
    assert got[-1] == ref[-1] == 6
    for g, r, k in zip(got[:-1], ref[:-1], ("o", "d", "t", "skip", "worth",
                                            "contrib")):
        _eq(g, r, k)
    assert got[4].float().mean() > 0.2


def test_vecmath_and_intersect_helpers_match_jax():
    """The rest of vecmath and intersect's slab_interval and
    brute_force_triangles against eager yuki_tpu, bit for bit, on numpy
    draws (closest hits over Cornell's triangles)."""
    from yuki_tpu import intersect as jint
    from yuki_tpu import vecmath as jvm
    from yuki_tpu_torch import intersect as tint
    from yuki_tpu_torch import vecmath as tvm

    rng = np.random.default_rng(12)
    a, b = (rng.standard_normal((256, 3)).astype(np.float32)
            for _ in range(2))
    k = [rng.integers(0, 3, 256).astype(np.int32) for _ in range(3)]
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    with jax.disable_jit():
        pairs = [
            (tvm.dot(ta, tb), jvm.dot(ja, jb)),
            (tvm.cross(ta, tb), jvm.cross(ja, jb)),
            (tvm.length(ta), jvm.length(ja)),
            (tvm.normalize(ta), jvm.normalize(ja)),
            (tvm.normalize_safe(ta), jvm.normalize_safe(ja)),
            (tvm.dist(ta, tb), jvm.dist(ja, jb)),
            (tvm.dist_sqr(ta, tb), jvm.dist_sqr(ja, jb)),
            (tvm.face_forward(ta, tb), jvm.face_forward(ja, jb)),
            (tvm.reflect(ta, tb), jvm.reflect(ja, jb)),
            (tvm.lerp(ta, tb, 0.3), jvm.lerp(ja, jb, 0.3)),
            (tvm.is_black(ta * (ta > 1)), jvm.is_black(ja * (ja > 1))),
            (tvm.max_dimension(ta), jvm.max_dimension(ja)),
            (tvm.permute(ta, *map(torch.as_tensor, k)),
             jvm.permute(ja, *map(jnp.asarray, k))),
        ]
        n = tvm.normalize(ta)
        pairs += list(zip(tvm.coordinate_system(n),
                          jvm.coordinate_system(jnp.asarray(n.numpy()))))
    for i, (g, r) in enumerate(pairs):
        _eq(g, r, f"vecmath case {i}")

    jscene, tscene, o, d, _, _, _, _ = _inputs("cornell")
    n = 96
    o, d = o[:n], d[:n]
    t_max = torch.full((n,), 1e4)
    lo, hi = tscene.data.world_lo, tscene.data.world_hi
    with jax.disable_jit():
        ref = jint.slab_interval(tp.to_jnp(o), tp.to_jnp(1.0 / d),
                                 tp.to_jnp(t_max), tp.to_jnp(lo),
                                 tp.to_jnp(hi))
        ref_hit, ref_prim = jint.brute_force_triangles(
            tp.to_jnp(o), tp.to_jnp(d), tp.to_jnp(t_max), jscene.data.tris)
    got = tint.slab_interval(o, 1.0 / d, t_max, lo, hi)
    for g, r in zip(got, ref):
        _eq(g, r, "slab_interval")
    hit, prim = tint.brute_force_triangles(o, d, t_max, tscene.data.tris)
    _eq(prim, ref_prim, "prim")
    for k in tint.TriHit._fields:
        _eq(getattr(hit, k), getattr(ref_hit, k), k)
    assert (prim >= 0).sum() > n // 2
