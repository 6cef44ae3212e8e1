"""Whitted's shade and resolve kernels (csrc/whitted_fused.cu) against
their plain twins on the card, bit for bit.

The walk runs in lockstep: each step the triangles' closest query, then
``whitted_shade`` (the kernel) and ``whitted_shade_plain`` on copies of
one state, every output held bit for bit; the occlusion query, then
``whitted_resolve`` and its twin, every field of the state (the stack
included) held bit for bit.  On a wave of Cornell's 1080p film (4096
tiles spread over it, 1,048,576 lanes) for UniformSampler and
StratifiedSampler(1, 1), at depths 1 and 3; on treelet scenes' hits
(the reduced colonnade; the mixed scene of test_torch_whitted_fused.py
with a 4,232-triangle sheet, glass and three lights) at depths 1 and 3;
on a lightless scene; on a textured sphere (its uv read by the
texture) at depths 1 and 3; at edge shapes (one lane, a ragged count,
every lane missing).  Then ``whitted_li`` on the card against the chain
(its route on CPU lanes, forced by ``integrators._card_lanes``), bit for
bit, every step the kernels', on Cornell and on the textured sphere.
Marked ``cuda``: they skip where torch.cuda.is_available() is False.
This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_whitted.py
"""

import dataclasses

import pytest
import torch

from test_torch_whitted_fused import camera_wave, mixed_scene
from torch_scenes import REDUCED
from yuki_tpu_torch import integrators as tintg
from yuki_tpu_torch import traverse
from yuki_tpu_torch.camera import Camera
from yuki_tpu_torch.integrators import WhittedParams
from yuki_tpu_torch.ops import whitted_fused as wf
from yuki_tpu_torch.sampling import SampleCtx, StratifiedSampler, UniformSampler

pytestmark = pytest.mark.cuda

SAMPLERS = {"uniform": UniformSampler(1), "strat": StratifiedSampler(1, 1)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def cornell_wave(sampler, n_tiles=4096, res=(1920, 1080), seed=2 ** 31 + 11):
    """(scene, ctx, o, d) of ``n_tiles`` 16x16 tiles of Cornell's 1080p
    film spread evenly over it in the renderer's tile order (the light,
    the walls, the copper sphere and the glass box all in the wave)."""
    from yuki_tpu_torch.scene.cornell import cornell

    dev = _card()
    scene, cam, _ = cornell(device=dev)
    tiles_x, tiles_y = -(-res[0] // 16), -(-res[1] // 16)
    t = torch.arange(n_tiles, device=dev) * (tiles_x * tiles_y) // n_tiles
    iy, ix = torch.meshgrid(torch.arange(16, device=dev),
                            torch.arange(16, device=dev), indexing="ij")
    px = ((t % tiles_x * 16)[:, None, None] + ix).reshape(-1)
    py = ((t // tiles_x * 16)[:, None, None] + iy).reshape(-1)
    px, py = px.to(torch.int32).contiguous(), py.to(torch.int32).contiguous()
    ctx = SampleCtx(px=px, py=py, sample_index=3, seed=seed)
    u = sampler.get_2d(ctx, 0)
    o, d = Camera.create(cam, *res).ray(
        torch.stack([px.float(), py.float()], -1) + u)
    return scene, ctx, o.contiguous(), d.contiguous()


def _copy(st):
    return dataclasses.replace(
        st, **{f.name: (getattr(st, f.name).clone() if f.name != "stack" else
                        {k: v.clone() for k, v in st.stack.items()})
               for f in dataclasses.fields(st)})


def _bits(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    bad = (a != b).reshape(a.shape[0], -1).any(dim=1) if a.numel() else a
    assert not bool(bad.any()), (
        f"{what}: {int(bad.sum())} of {a.shape[0]} rows differ, first "
        f"{bad.nonzero()[:4].flatten().tolist()}")


def _same_state(k, p, what):
    for f in dataclasses.fields(k):
        if f.name == "stack":
            for key in k.stack:
                _bits(k.stack[key], p.stack[key], f"{what} stack {key}")
        else:
            _bits(getattr(k, f.name), getattr(p, f.name), f"{what} {f.name}")


def lockstep(scene, sampler, ctx, o, d, depth, min_steps=1):
    """The walk by the kernels and by the twins side by side, each output
    and state held bit for bit; returns the steps walked."""
    data, meta = scene.data, scene.meta
    n = o.shape[0]
    tb = wf.make_whitted_tables(scene, WhittedParams(depth), n)
    st_k = wf.init_state(tb, o, d)
    st_p = _copy(st_k)
    n_lights = tb.n_lights
    ph = (tintg._ph_i32(ctx) if n_lights and isinstance(
        sampler, UniformSampler) else None)
    budget = tintg.whitted_step_budget(depth, 1 in meta.material_types)
    steps = 0
    wf.reset_launches()
    while steps < budget and bool(st_k.pending.any()):
        dim0 = 2 + steps * 2 * n_lights
        draws = wf.step_draws(sampler, ctx, dim0, n_lights)
        tri_hit = traverse.closest_triangles(data, meta, st_k.o, st_k.d,
                                             st_k.t_max)
        so_k = wf.whitted_shade(tb, st_k, tri_hit, dim0, draws, ph)
        so_p = wf.whitted_shade_plain(tb, st_p, tri_hit, dim0, draws, ph)
        for field in wf.ShadeOut._fields:
            _bits(getattr(so_k, field), getattr(so_p, field),
                  f"step {steps} shade {field}")
        _bits(st_k.ray_count, st_p.ray_count, f"step {steps} ray_count")
        occ = (traverse.any_triangles(data, meta, so_k.no, so_k.nd, so_k.nt,
                                      tb.skip) if n_lights else
               torch.zeros(0, dtype=torch.bool, device=o.device))
        wf.whitted_resolve(tb, st_k, so_k, occ)
        wf.whitted_resolve_plain(tb, st_p, so_p, occ)
        _same_state(st_k, st_p, f"step {steps} resolve")
        steps += 1
    torch.cuda.synchronize()
    assert wf.LAUNCHES == {"whitted_shade": steps, "whitted_resolve": steps}
    assert steps >= min_steps
    return steps


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_kernels_match_twins_on_cornell_wave(name, depth):
    sampler = SAMPLERS[name]
    scene, ctx, o, d = cornell_wave(sampler)
    assert o.shape[0] == 1 << 20
    steps = lockstep(scene, sampler, ctx, o, d, depth,
                     min_steps=1 if depth == 1 else 5)
    assert steps == 1 or depth == 3


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("which", ["colonnade", "mixed_sheet"])
def test_kernels_match_twins_on_treelet_hits(which, depth):
    from yuki_tpu_torch.scene.testscenes import colonnade

    dev = _card()
    if which == "colonnade":
        scene, cam, _ = colonnade(device=dev, **REDUCED)
    else:
        scene, cam = mixed_scene(dev, sheet=46)
    assert scene.meta.traversal == "treelet"
    sampler = StratifiedSampler(1, 1)
    ctx, o, d = camera_wave(scene, cam, sampler, (256, 192), seed=2 ** 32 - 3)
    glass = 1 in scene.meta.material_types
    lockstep(scene, sampler, ctx, o, d, depth,
             min_steps=3 if glass and depth == 3 else 1)


def _sun_sphere(dev):
    import torch_scenes
    from yuki_tpu_torch import camera as cam_mod
    from yuki_tpu_torch import transforms as tf
    from yuki_tpu_torch.scene import data as sd

    scene, cam = torch_scenes.sun_sphere(sd, tf, cam_mod, device=dev)
    assert not scene.meta.sphere_mats_untextured
    return scene, cam


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_kernels_match_twins_on_a_textured_sphere(name, depth):
    """A sphere whose matte reads a texture at its uv (atan2f in the
    kernel, torch.atan2 in the twin), a glass box, a distant and a point
    light."""
    scene, cam = _sun_sphere(_card())
    sampler = SAMPLERS[name]
    ctx, o, d = camera_wave(scene, cam, sampler, (512, 384), seed=2 ** 31 + 7)
    hit = traverse.intersect(scene.data, scene.meta, o, d,
                             torch.full((o.shape[0],), traverse.F32_MAX,
                                        device=o.device))
    assert int((hit.sphere == 0).sum()) > 10_000
    lockstep(scene, sampler, ctx, o, d, depth,
             min_steps=3 if depth == 3 else 1)


def test_kernels_match_twins_without_lights():
    """No light, no shadow ray: the sky on misses, metal and glass
    spheres."""
    import torch_scenes
    from yuki_tpu_torch import camera as cam_mod
    from yuki_tpu_torch import transforms as tf
    from yuki_tpu_torch.scene import data as sd

    scene, cam = torch_scenes.lightless(sd, tf, cam_mod, device=_card())
    sampler = UniformSampler(1)
    ctx, o, d = camera_wave(scene, cam, sampler, (256, 192))
    lockstep(scene, sampler, ctx, o, d, 3, min_steps=3)


@pytest.mark.parametrize("shape", ["one", "ragged", "all_miss"])
def test_kernels_match_twins_at_edge_shapes(shape):
    sampler = UniformSampler(1)
    scene, ctx, o, d = cornell_wave(sampler, n_tiles=8)
    if shape == "one":
        keep = slice(700, 701)
    elif shape == "ragged":
        keep = slice(3, 3 + 1000)
    else:
        keep = slice(0, 300)
        d = -d  # away from the box, out of the scene
    ctx = SampleCtx(px=ctx.px[keep].contiguous(), py=ctx.py[keep].contiguous(),
                    sample_index=ctx.sample_index, seed=ctx.seed)
    lockstep(scene, sampler, ctx, o[keep].contiguous(), d[keep].contiguous(),
             3)


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_whitted_li_on_the_card_against_the_chain(name, monkeypatch):
    sampler = SAMPLERS[name]
    scene, ctx, o, d = cornell_wave(sampler, n_tiles=1024)
    out = {}
    for card in (False, True):
        monkeypatch.setattr(tintg, "_card_lanes", lambda o: card)
        tintg.reset_counts()
        out[card] = (tintg.whitted_li(scene, scene.meta, WhittedParams(3),
                                      sampler, ctx, o, d), dict(tintg.COUNTS))
    (chain, c_chain), (fused, c_fused) = out[False], out[True]
    assert c_chain["whitted_fused_steps"] == 0
    assert c_fused["whitted_fused_steps"] == c_fused["whitted_steps"] \
        == c_chain["whitted_steps"] > 1
    _bits(fused.li, chain.li, "radiance")
    _bits(fused.ray_count, chain.ray_count, "ray count")


def test_whitted_li_on_the_card_with_a_textured_sphere(monkeypatch):
    """whitted_li on the card takes the kernels for a textured sphere too,
    with the chain's bits."""
    scene, cam = _sun_sphere(_card())
    sampler = StratifiedSampler(1, 1)
    ctx, o, d = camera_wave(scene, cam, sampler, (512, 384))
    out = {}
    for card in (False, True):
        monkeypatch.setattr(tintg, "_card_lanes", lambda o: card)
        tintg.reset_counts()
        out[card] = (tintg.whitted_li(scene, scene.meta, WhittedParams(3),
                                      sampler, ctx, o, d), dict(tintg.COUNTS))
    (chain, c_chain), (fused, c_fused) = out[False], out[True]
    assert c_fused["whitted_fused_steps"] == c_fused["whitted_steps"] \
        == c_chain["whitted_steps"] > 1
    _bits(fused.li, chain.li, "radiance")
    _bits(fused.ray_count, chain.ray_count, "ray count")
