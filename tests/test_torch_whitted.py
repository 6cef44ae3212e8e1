"""The port's Whitted integrator (integrators.whitted_li) on the CPU.

Against the committed goldens, with no JAX at test time: Cornell at
64x48, Whitted(3), 2 spp, seed 42 (tests/goldens/
cornell_64x48_whitted3_2spp_seed42.npz, yuki_tpu's render; its glass box
grows the specular tree past one step, within the 7 of depth 3) and the
colonnade, a treelet scene whose queries take the coherence sort, at
64x48, Whitted(3), 1 spp, seed 1 (tests/goldens/
torch_colonnade_64x48_whitted3_1spp_seed1.npz, made by
torch_parity.colonnade_whitted_golden_jax; one test shows it is current),
both through render_frame under the chaos-aware bounds of
torch_parity.assert_parity.  Then the tree itself: the stack is last in,
first out; depth 1 spawns no child; the step budget holds; and one
16x16 StratifiedSampler(2, 2) render against yuki_tpu's jitted
make_wave_renderer."""

from pathlib import Path

import numpy as np
import torch

import torch_parity as tp
from yuki_tpu_torch import integrators as tintg
from yuki_tpu_torch.camera import Camera
from yuki_tpu_torch.film import FilmSettings
from yuki_tpu_torch.integrators import WhittedParams
from yuki_tpu_torch.renderer import make_wave_renderer, render_frame
from yuki_tpu_torch.sampling import SampleCtx, UniformSampler

torch.set_num_threads(2)

GOLDENS = Path(__file__).parent / "goldens"
CORNELL = GOLDENS / "cornell_64x48_whitted3_2spp_seed42.npz"
COLONNADE = GOLDENS / "torch_colonnade_64x48_whitted3_1spp_seed1.npz"


def test_cornell_golden():
    scene, cam = tp.port_scene("cornell")
    tintg.reset_counts()
    res = render_frame(scene, cam, FilmSettings(res=tp.RES, tile_dim=16),
                       UniformSampler(2), WhittedParams(3), wave_tiles=12,
                       seed=42)
    img = res.film.image()
    gold = np.load(CORNELL)["img"]
    assert img.shape == gold.shape and np.isfinite(img).all()
    tp.assert_parity(gold, None, img, None, depth=3, spp=2)
    # The glass box's tree: more than one step a wave, at most 7 at
    # depth 3 (two waves: one a sample).
    assert 2 < tintg.COUNTS["whitted_steps"] <= 2 * 7
    assert res.ray_count > 2 * tp.RES[0] * tp.RES[1]


def test_colonnade_golden_is_current():
    np.testing.assert_array_equal(tp.colonnade_whitted_golden_jax(),
                                  np.load(COLONNADE)["img"])


def test_colonnade_golden():
    from yuki_tpu_torch import traverse

    scene, cam = tp.port_scene("colonnade")
    assert scene.meta.traversal == "treelet"
    traverse.reset_counts()
    res = render_frame(scene, cam, FilmSettings(res=tp.RES, tile_dim=16),
                       UniformSampler(1), WhittedParams(3), wave_tiles=12,
                       seed=1)
    img = res.film.image()
    gold = np.load(COLONNADE)["img"]
    assert img.shape == gold.shape and np.isfinite(img).all()
    tp.assert_parity(gold, None, img, None, depth=3)
    c = traverse.counts()
    assert c["closest_rows"] + c["closest_slot"] + c["fallbacks"] > 0
    assert c["any_rows"] + c["any_slot"] > 0


def test_stack_is_lifo():
    """Pushes land at each lane's pointer only where masked; pops read
    the last pushed entry; an empty stack pops its bottom entry."""
    n, size = 4, 3
    stack = {"d": torch.zeros((size, n, 3)),
             "depth": torch.zeros((size, n), dtype=torch.int32)}
    sp = torch.zeros(n, dtype=torch.int32)
    for k in (1, 2):
        mask = torch.tensor([True, k == 1, True, False])
        sp = tintg._push(stack, sp, {
            "d": torch.full((n, 3), float(k)),
            "depth": torch.full((n,), k, dtype=torch.int32)}, mask)
    assert sp.tolist() == [2, 1, 2, 0]
    item, sp = tintg._pop(stack, sp, sp > 0)
    assert item["depth"].tolist() == [2, 1, 2, 0]
    assert item["d"][:, 0].tolist() == [2.0, 1.0, 2.0, 0.0]
    item, sp = tintg._pop(stack, sp, sp > 0)
    assert item["depth"].tolist() == [1, 1, 1, 0]
    assert sp.tolist() == [0, 0, 0, 0]


def _camera_li(depth, n_px=(32, 24)):
    scene, cam = tp.port_scene("cornell")
    camera = Camera.create(cam, *n_px)
    py, px = torch.meshgrid(torch.arange(n_px[1], dtype=torch.int32),
                            torch.arange(n_px[0], dtype=torch.int32),
                            indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    ctx = SampleCtx(px=px, py=py, sample_index=0, seed=5)
    sampler = UniformSampler(1)
    u = sampler.get_2d(ctx, 0)
    o, d = camera.ray(torch.stack([px.float(), py.float()], -1) + u)
    tintg.reset_counts()
    res = tintg.whitted_li(scene, scene.meta, WhittedParams(depth), sampler,
                           ctx, o, d)
    return res, tintg.COUNTS["whitted_steps"]


def test_depth1_spawns_no_child():
    """Depth 1: one step, one closest ray a lane; the lanes that take one
    ray at depth 3 (no glass on their path) are equal bit for bit."""
    one, steps1 = _camera_li(1)
    three, steps3 = _camera_li(3)
    assert steps1 == 1 and bool((one.ray_count == 1).all())
    assert 1 < steps3 <= 7 and int(three.ray_count.max()) > 1
    single = three.ray_count == 1
    assert single.float().mean() > 0.5
    assert torch.equal(one.li[single], three.li[single])
    assert not torch.equal(one.li[~single], three.li[~single])


def test_step_budget(monkeypatch):
    assert tintg.whitted_step_budget(3, has_glass=False) == 1
    assert tintg.whitted_step_budget(3, has_glass=True) == 7
    assert tintg.whitted_step_budget(12, has_glass=True) == 255
    # A budget below the tree's size cuts the walk there.
    monkeypatch.setattr(tintg, "_MAX_SPECULAR_STEPS", 2)
    res, steps = _camera_li(3)
    assert steps == 2 and int(res.ray_count.max()) == 2


def test_stratified_matches_jax():
    """A 16x16 film of Cornell, Whitted(3), StratifiedSampler(2, 2), the
    four samples summed in one launch, against yuki_tpu's jitted
    make_wave_renderer (a lax.scan over the samples)."""
    import jax.numpy as jnp

    from yuki_tpu import integrators as jintg
    from yuki_tpu.camera import Camera as JCamera
    from yuki_tpu.renderer import make_wave_renderer as jax_mwr

    res, td = (16, 16), 8
    origins = np.array([[0, 0], [8, 0], [0, 8], [8, 8]], np.int32)
    jsam, tsam = tp.samplers((2, 2))
    jscene, jcam = tp.jax_scene("cornell")
    render = jax_mwr(jscene, JCamera.create(jcam, *res), jsam,
                     jintg.WhittedParams(3), td, 4, samples_per_launch=4)
    px, rays = render(jnp.asarray(origins), jnp.int32(0), jnp.uint32(3))
    ref, rays_ref = np.asarray(px) / 4, float(rays)
    tscene, tcam = tp.port_scene("cornell")
    render = make_wave_renderer(tscene, Camera.create(tcam, *res), tsam,
                                WhittedParams(3), td, 4,
                                samples_per_launch=4)
    px, rays = render(origins, 0, 3)
    got = px.numpy() / 4
    assert np.isfinite(got).all() and got.mean() > 0
    tp.assert_parity(ref, rays_ref, got, float(rays), depth=3, spp=4)
