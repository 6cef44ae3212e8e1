"""Whitted's kernel route (ops/whitted_fused) on the CPU, without JAX: its
plain twins against the shading chain bit for bit.

On CPU lanes ``whitted_shade`` and ``whitted_resolve`` run their plain
twins, ``whitted_shade_plain`` and ``whitted_resolve_plain``, which the
card's kernels are held to bit for bit (tests/test_torch_cuda_whitted.py).
Here the twins are held to the chain: one step's shadow rays,
contributions and children against ``_nee_setup`` and
``bsdf_sample_specular`` on the chain's own surface, and the twin-driven
``integrators._whitted_fused`` against ``whitted_li``'s chain at depths
1-3, with exact ray counts, on Cornell at 64x48 (rect light, glass box,
copper sphere, textured wall) for UniformSampler and StratifiedSampler(1,
1); on a dense scene with three lights (point, spot, rect; a sigma matte
floor under a texture, glossy, metal and glass) for the light-major sum;
on a lightless scene; and on a textured treelet scene (rect and distant
light) whose queries take the dispatch.  Then the stack's last-in,
first-out order through the glass box, and a textured sphere, whose uv
the route computes, through ``whitted_li`` with its lanes taken for the
card's.
"""

import numpy as np
import pytest
import torch

from yuki_tpu_torch import camera as cam_mod
from yuki_tpu_torch import integrators as tintg
from yuki_tpu_torch import transforms as tf
from yuki_tpu_torch import traverse
from yuki_tpu_torch.camera import Camera
from yuki_tpu_torch.integrators import WhittedParams
from yuki_tpu_torch.ops import whitted_fused as wf
from yuki_tpu_torch.sampling import SampleCtx, StratifiedSampler, UniformSampler
from yuki_tpu_torch.scene import data as sd
from yuki_tpu_torch.scene.cornell import cornell

torch.set_num_threads(2)

SAMPLERS = {"uniform": UniformSampler(1), "strat": StratifiedSampler(1, 1)}


def mixed_scene(device, sheet=0):
    """A dense scene for every light type but the distant one and every
    material family: a sigma matte floor under a texture, a glossy back
    wall, a glass box, a metal and a glass sphere, a point, a spot and a
    rect light, and a sky.  ``sheet``: a rippled sheet of 2 sheet^2 matte
    triangles behind the box (a treelet scene from sheet = 46 on)."""
    b = sd.SceneBuilder("whitted-mixed")
    b.background = np.array([0.05, 0.07, 0.1], np.float32)
    img = np.random.default_rng(3).integers(0, 256, (8, 8, 3)) / 255.0
    tex = b.add_texture(img.astype(np.float32))
    floor = b.add_matte(kd=(0.6, 0.6, 0.55), sigma=0.3, kd_tex=tex)
    wall = b.add_glossy(rs=(0.4, 0.35, 0.3), roughness=0.3)
    glass = b.add_glass(r=(1.0, 1.0, 1.0), t=(0.9, 0.95, 1.0), eta=1.5)
    s = 4.0
    b.add_mesh(tf.Transform.identity(), [0, 2, 1, 0, 3, 2],
               [(-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s)],
               uvs=[(0, 0), (3, 0), (3, 3), (0, 3)], material=floor)
    b.add_mesh(tf.Transform.identity(), [0, 1, 2, 0, 2, 3],
               [(-s, 0, -2), (s, 0, -2), (s, 3, -2), (-s, 3, -2)],
               material=wall)
    lo, hi = (0.3, 0.0, -0.6), (1.3, 1.0, 0.4)
    corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                        for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
                       np.float32)
    faces = [0, 1, 3, 0, 3, 2, 4, 6, 7, 4, 7, 5, 0, 4, 5, 0, 5, 1,
             2, 3, 7, 2, 7, 6, 0, 2, 6, 0, 6, 4, 1, 5, 7, 1, 7, 3]
    b.add_mesh(tf.Transform.identity(), faces, corners, material=glass)
    if sheet:
        xs = np.linspace(-3.0, 3.0, sheet + 1, dtype=np.float32)
        gx, gy = np.meshgrid(xs, xs / 2.0 + 1.5, indexing="ij")
        pts = np.stack([gx, gy, -1.5 + 0.15 * np.sin(3.0 * gx) * np.cos(
            2.0 * gy)], -1).reshape(-1, 3).astype(np.float32)
        idx = []
        for i in range(sheet):
            for j in range(sheet):
                a = i * (sheet + 1) + j
                idx += [a, a + sheet + 1, a + sheet + 2, a, a + sheet + 2,
                        a + 1]
        b.add_mesh(tf.Transform.identity(), idx, pts,
                   material=b.add_matte(kd=(0.5, 0.55, 0.6)))
    b.add_sphere(tf.translation((-1.0, 0.6, 0.0)), 0.6,
                 b.add_metal(eta=(0.2, 0.9, 1.1), k=(3.9, 2.4, 2.2),
                             roughness=0.2))
    b.add_sphere(tf.translation((-0.2, 0.35, 0.9)), 0.35, glass)
    b.add_point_light(tf.translation((1.5, 2.5, 1.5)), (4.0, 4.0, 4.0))
    b.add_spot_light(tf.look_at((-1.5, 2.8, 1.0), (0.0, 0.0, 0.0),
                                (0.0, 1.0, 0.0)).inverted(),
                     (9.0, 8.0, 7.0), 35.0, 25.0)
    b.add_rect_light(tf.translation((0.0, 2.9, 0.0)), (6.0, 6.0, 5.5),
                     (1.0, 1.0))
    cam = cam_mod.CameraParameters(
        position=(0.0, 1.6, 5.0), target=(0.0, 0.6, 0.0),
        up=(0.0, 1.0, 0.0), fov=cam_mod.FoV.x(55.0),
    )
    return b.build(device=device), cam


def camera_wave(scene, cam, sampler, res=(64, 48), sample_index=0,
                seed=5):
    """(ctx, o, d) of every pixel of a ``res`` film, jittered by the
    sampler's dimensions 0-1, on the scene's device."""
    dev = scene.device
    py, px = torch.meshgrid(torch.arange(res[1], dtype=torch.int32),
                            torch.arange(res[0], dtype=torch.int32),
                            indexing="ij")
    px, py = px.reshape(-1).to(dev), py.reshape(-1).to(dev)
    ctx = SampleCtx(px=px, py=py, sample_index=sample_index, seed=seed)
    u = sampler.get_2d(ctx, 0)
    o, d = Camera.create(cam, *res).ray(
        torch.stack([px.float(), py.float()], -1) + u)
    return ctx, o.contiguous(), d.contiguous()


def _scene(name):
    if name == "cornell":
        scene, cam, _ = cornell(device="cpu")
        return scene, cam
    if name == "mixed":
        return mixed_scene("cpu")
    import torch_scenes

    return getattr(torch_scenes, name)(sd, tf, cam_mod, device="cpu")


def _li_both(scene, cam, sampler, depth, res=(64, 48)):
    """(chain, twin-driven kernel route) LiResults and the route's step
    counts."""
    ctx, o, d = camera_wave(scene, cam, sampler, res)
    params = WhittedParams(depth)
    chain = tintg.whitted_li(scene, scene.meta, params, sampler, ctx, o, d)
    tintg.reset_counts()
    fused = tintg._whitted_fused(scene, scene.meta, params, sampler, ctx, o,
                                 d, 2)
    return chain, fused, dict(tintg.COUNTS)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_one_step_against_the_chain(name):
    """Step 0 of Cornell's wave: the twin shade's shadow rays and
    contributions equal _nee_setup's on the chain's surface (contributions
    where a ray is worth it), its emission and children the chain's, its
    lane flags the chain's masks; after the resolve twin the radiance and
    ray counts equal whitted_li's with a budget of one step."""
    from yuki_tpu_torch import bsdf
    from yuki_tpu_torch.lights import area_light_radiance
    from yuki_tpu_torch.ops.trace import F32_MAX
    from yuki_tpu_torch.surface import make_surface, spawn_ray
    from yuki_tpu_torch.vecmath import dot

    sampler = SAMPLERS[name]
    scene, cam = _scene("cornell")
    data, meta = scene.data, scene.meta
    ctx, o, d = camera_wave(scene, cam, sampler)
    n = o.shape[0]
    params = WhittedParams(3)
    tb = wf.make_whitted_tables(scene, params, n)
    st = wf.init_state(tb, o, d)
    draws = wf.step_draws(sampler, ctx, 2, tb.n_lights)
    ph = tintg._ph_i32(ctx) if draws is None else None
    tri_hit = traverse.closest_triangles(data, meta, st.o, st.d, st.t_max)
    so = wf.whitted_shade(tb, st, tri_hit, 2, draws, ph)

    t_max = torch.full((n,), F32_MAX)
    hit = traverse.intersect(data, meta, o, d, t_max)
    si = make_surface(data, hit, o, d)
    mp = bsdf.gather_materials(data, si, meta)
    no, nd, nt, skip, worth, contrib, dim = tintg._nee_setup(
        data, meta, sampler, ctx, si, mp, 2, hit.hit)
    assert dim == 2 + 2 * tb.n_lights
    assert _same(so.no, no) and _same(so.nd, nd) and _same(so.nt, nt)
    assert _same(tb.skip, skip)
    assert _same(so.nc[worth], contrib[worth])
    assert bool((so.nc[~worth] == 0.0).all())
    assert _same(so.emit, area_light_radiance(data, si, -d))
    for flag, bs_t in ((wf.REFL, False), (wf.TRANS, True)):
        bs = bsdf.bsdf_sample_specular(mp, si, si.wo, bs_t)
        rows = so.refl if flag == wf.REFL else so.trans
        scale = bs.f * torch.abs(dot(bs.wi, si.ns))[..., None]
        scale = torch.where(torch.isfinite(scale), scale, 0.0)
        assert _same(rows, torch.cat([spawn_ray(si, bs.wi), bs.wi, scale], 1))
        assert torch.equal((so.lane & flag) > 0, hit.hit & bs.valid)
    assert torch.equal((so.lane & wf.LIVE) > 0, hit.hit)
    assert torch.equal((so.lane & wf.MISSED) > 0, ~hit.hit)
    assert int(((so.lane & wf.TRANS) > 0).sum()) > 50  # the glass box

    occ = traverse.any_triangles(data, meta, so.no, so.nd, so.nt, tb.skip)
    wf.whitted_resolve(tb, st, so, occ)
    budget = tintg._MAX_SPECULAR_STEPS
    tintg._MAX_SPECULAR_STEPS = 1
    try:
        chain = tintg.whitted_li(scene, meta, params, sampler, ctx, o, d)
    finally:
        tintg._MAX_SPECULAR_STEPS = budget
    assert _same(st.radiance, chain.li)
    assert _same(st.ray_count, chain.ray_count)
    assert torch.equal(st.active, ((so.lane & wf.REFL) > 0)
                       | ((so.lane & wf.TRANS) > 0))


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_whitted_li_against_the_chain(name, depth):
    """The twin-driven route on Cornell at depths 1-3: radiance bit for
    bit, ray counts exact, every step the twins'."""
    scene, cam = _scene("cornell")
    chain, fused, counts = _li_both(scene, cam, SAMPLERS[name], depth)
    assert _same(fused.li, chain.li)
    assert _same(fused.ray_count, chain.ray_count)
    steps = counts["whitted_steps"]
    assert counts["whitted_fused_steps"] == steps
    assert steps == (1 if depth == 1 else (3 if depth == 2 else 5))
    assert int(fused.ray_count.max()) == min(steps, 2 ** depth - 1)
    assert float(fused.li.mean()) > 0.1


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_three_lights_sum_light_major(name):
    """Point, spot and rect lights: the shadow rays go out light-major
    and the lit contributions add in light order, bit for bit against the
    chain at depth 3 (glass box and sphere, metal, glossy, a sigma matte
    under a texture, misses into the sky)."""
    scene, cam = _scene("mixed")
    meta = scene.meta
    assert len(meta.light_types) == 3 and meta.has_textures and meta.has_sigma
    assert set(meta.material_types) == {0, 1, 2, 3}
    assert meta.traversal == "dense" and meta.n_spheres == 2
    chain, fused, counts = _li_both(scene, cam, SAMPLERS[name], 3,
                                    res=(48, 32))
    assert _same(fused.li, chain.li)
    assert _same(fused.ray_count, chain.ray_count)
    assert counts["whitted_fused_steps"] == counts["whitted_steps"] > 2

    # Each light's own shadow rays sit in its block of N lanes.
    sampler = SAMPLERS[name]
    ctx, o, d = camera_wave(scene, cam, sampler, (48, 32))
    n = o.shape[0]
    tb = wf.make_whitted_tables(scene, WhittedParams(3), n)
    st = wf.init_state(tb, o, d)
    tri_hit = traverse.closest_triangles(scene.data, meta, st.o, st.d,
                                         st.t_max)
    draws = wf.step_draws(sampler, ctx, 2, 3)
    so = wf.whitted_shade(tb, st, tri_hit, 2, draws,
                          tintg._ph_i32(ctx) if draws is None else None)
    worth = so.nt[2 * n:] > 0
    ends = (so.no[2 * n:] + so.nd[2 * n:])[worth]
    assert ends.shape[0] > 100
    assert bool(((ends[:, 1] - 2.9).abs() < 1e-4).all())  # on the rect
    assert torch.equal(tb.skip, torch.tensor([-2] * (2 * n) + [2] * n,
                                             dtype=torch.int32))


def test_lightless_scene():
    """No light: no shadow rays, the sky on misses, metal and glass
    spheres; the route against the chain at depth 3."""
    scene, cam = _scene("lightless")
    assert not scene.meta.light_types
    chain, fused, counts = _li_both(scene, cam, UniformSampler(1), 3,
                                    res=(48, 32))
    assert _same(fused.li, chain.li)
    assert _same(fused.ray_count, chain.ray_count)
    assert counts["whitted_steps"] > 1


def test_treelet_scene():
    """A textured treelet scene (rect and distant light, a sigma matte):
    its queries take the dispatch, sorted; the route against the chain."""
    scene, cam = _scene("textured_treelet")
    assert scene.meta.traversal == "treelet"
    chain, fused, counts = _li_both(scene, cam, StratifiedSampler(1, 1), 3,
                                    res=(32, 24))
    assert _same(fused.li, chain.li)
    assert _same(fused.ray_count, chain.ray_count)
    assert counts["whitted_fused_steps"] == counts["whitted_steps"] == 1


def test_stack_is_lifo_through_glass():
    """Cornell at depth 3 step by step: a lane that spawns both children
    goes on with the reflection and pushes the transmission; a lane with
    no reflection child goes on with the child it pushed last."""
    scene, cam = _scene("cornell")
    data, meta = scene.data, scene.meta
    sampler = UniformSampler(1)
    ctx, o, d = camera_wave(scene, cam, sampler)
    n = o.shape[0]
    tb = wf.make_whitted_tables(scene, WhittedParams(3), n)
    st = wf.init_state(tb, o, d)
    ph = tintg._ph_i32(ctx)
    model = [[] for _ in range(n)]
    pops = both = 0
    for step in range(7):
        tri_hit = traverse.closest_triangles(data, meta, st.o, st.d, st.t_max)
        so = wf.whitted_shade(tb, st, tri_hit, 2 + 2 * step, None, ph)
        occ = traverse.any_triangles(data, meta, so.no, so.nd, so.nt, tb.skip)
        wf.whitted_resolve(tb, st, so, occ)
        lane = so.lane.tolist()
        for i in range(n):
            if lane[i] & wf.TRANS:
                model[i].append(so.trans[i, :6])
            if lane[i] & wf.REFL:
                want = so.refl[i, :6]
                both += bool(lane[i] & wf.TRANS)
            elif model[i]:
                want = model[i].pop()
                pops += 1
            else:
                assert not bool(st.active[i])
                continue
            assert bool(st.active[i])
            assert torch.equal(torch.cat([st.o[i], st.d[i]]), want)
        assert st.sp.tolist() == [len(m) for m in model]
        if not bool(st.pending.any()):
            break
    assert both > 20 and pops > 20
    assert all(not m for m in model)


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_textured_sphere_takes_the_route(name, monkeypatch):
    """A textured sphere under a distant and a point light: whitted_li
    with its lanes taken for the card's runs the route (its twins here),
    every step the route's, with the chain's bits; the sphere's lanes read
    the texture at their uv."""
    scene, cam = _scene("sun_sphere")
    assert scene.meta.n_spheres == 1
    assert not scene.meta.sphere_mats_untextured
    sampler = SAMPLERS[name]
    ctx, o, d = camera_wave(scene, cam, sampler, (48, 32))
    runs = {}
    for card in (True, False):
        monkeypatch.setattr(tintg, "_card_lanes", lambda o: card)
        tintg.reset_counts()
        runs[card] = (tintg.whitted_li(scene, scene.meta, WhittedParams(3),
                                       sampler, ctx, o, d), dict(tintg.COUNTS))
    (fused, c_fused), (chain, c_chain) = runs[True], runs[False]
    assert c_fused["whitted_fused_steps"] == c_fused["whitted_steps"] > 1
    assert c_chain["whitted_fused_steps"] == 0
    assert _same(fused.li, chain.li)
    assert _same(fused.ray_count, chain.ray_count)
    hit = traverse.intersect(scene.data, scene.meta, o, d,
                             torch.full((o.shape[0],), traverse.F32_MAX))
    assert int((hit.sphere == 0).sum()) > 50
