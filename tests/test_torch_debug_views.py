"""The four debug views (GeometryNormals, ShadingNormals, ShadingUVs,
BVHIntersections) through the port's make_wave_renderer on the CPU,
against yuki_tpu's jitted make_wave_renderer on the whole 64x48 Cornell
film.  XLA contracts FMAs in its jitted camera rays and triangle tests,
so a few lanes' rays differ by ulps: the normal views agree within 1e-4
everywhere; ShadingUVs differs beyond that only where the ceiling light's
quad lies flush with the ceiling (which of the two coplanar triangles
wins follows those ulps; measured 47 pixels, 1.5%), BVHIntersections
where a ray's node steps differ (measured 43 pixels, 1.4%, by at most
2 steps); both are held to 3% of the pixels, the means to rtol 2e-3."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from yuki_tpu_torch.camera import Camera
from yuki_tpu_torch.renderer import make_wave_renderer
from yuki_tpu_torch.sampling import UniformSampler

torch.set_num_threads(2)

TILES = 48
ORIGINS = np.stack([np.arange(TILES, dtype=np.int32) % 8 * tp.TD,
                    np.arange(TILES, dtype=np.int32) // 8 * tp.TD], axis=1)


def _both(view, seed=1):
    import jax.numpy as jnp

    from yuki_tpu.camera import Camera as JCamera
    from yuki_tpu.renderer import make_wave_renderer as jax_mwr

    jscene, jcam = tp.jax_scene("cornell")
    render = jax_mwr(jscene, JCamera.create(jcam, *tp.RES),
                     tp.samplers()[0], view, tp.TD, TILES)
    ref, rays_ref = render(jnp.asarray(ORIGINS), jnp.int32(0),
                           jnp.uint32(seed))
    tscene, tcam = tp.port_scene("cornell")
    render = make_wave_renderer(tscene, Camera.create(tcam, *tp.RES),
                                UniformSampler(1), view, tp.TD, TILES)
    got, rays = render(ORIGINS, 0, seed)
    assert float(rays) == float(rays_ref) == tp.RES[0] * tp.RES[1]
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("view,share", [
    ("geometry_normals", 0.0), ("shading_normals", 0.0),
    ("shading_uvs", 0.03), ("bvh_intersections", 0.03)])
def test_view_matches_jax(view, share):
    ref, got = _both(view)
    assert np.isfinite(got).all() and got.max() > 0
    bad = (np.abs(got - ref) > 1e-4 + 1e-4 * np.abs(ref)).reshape(-1, 3)
    assert bad.any(axis=-1).mean() <= share
    np.testing.assert_allclose(got.mean(), ref.mean(), rtol=2e-3)
    if view == "bvh_intersections":
        np.testing.assert_array_equal(got, np.round(got))  # whole steps
        assert np.abs(got - ref).max() <= 2
        assert (got[..., 0] == got[..., 1]).all()
        assert got.max() > 10
