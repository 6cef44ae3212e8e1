"""The port's sampler, camera, transform appliers and film against the
JAX package.  Hashes and sample values are integer/exact maths and must
match bit for bit, including pixels past 2^15 (the px << 16 key wraps)
and seeds past 2^31; camera matrices are host numpy and must be equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from yuki_tpu import film as jfilm
from yuki_tpu import sampling as js
from yuki_tpu import transforms as jtf
from yuki_tpu.camera import Camera as JCamera
from yuki_tpu.scene.cornell import cornell as jcornell
from yuki_tpu_torch import film as tfilm
from yuki_tpu_torch import sampling as ts
from yuki_tpu_torch import transforms as ttf
from yuki_tpu_torch.camera import Camera

torch.set_num_threads(2)

PX = np.array([0, 1, 7, 255, 1919, 32767, 32768, 40000, 65535, 65536,
               123457], np.int64)
PY = np.array([0, 3, 1079, 65535, 9, 2, 77777, 5, 1, 0, 40000], np.int64)
SAMPLES = [0, 1, 15, 2 ** 31 + 5]
SEEDS = [0, 1, 7, 2 ** 31, 2 ** 32 - 1]
DIMS = [0, 1, 2, 17, 4096]


def _u32(x):
    return np.asarray(x).astype(np.int64)


def test_pcg_hash_and_hash_key_bit_exact():
    x = np.random.default_rng(0).integers(0, 2 ** 32, 4096, dtype=np.int64)
    ref = np.asarray(js.pcg_hash(jnp.asarray(x.astype(np.uint32))))
    got = ts.pcg_hash(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, _u32(ref))
    for seed in SEEDS:
        ref = js.hash_key(jnp.uint32(seed), jnp.asarray(x.astype(np.uint32)))
        got = ts.hash_key(seed, torch.as_tensor(x))
        np.testing.assert_array_equal(got.numpy(), _u32(ref))


def test_u32_to_unit_float_bit_exact():
    x = np.random.default_rng(1).integers(0, 2 ** 32, 4096, dtype=np.int64)
    x[:3] = [0, 2 ** 32 - 1, 255]
    ref = np.asarray(js.u32_to_unit_float(jnp.asarray(x.astype(np.uint32))))
    got = ts.u32_to_unit_float(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_sampler_bit_exact(seed):
    jsam, tsam = js.UniformSampler(4), ts.UniformSampler(4)
    for si in SAMPLES:
        jctx = js.SampleCtx(px=jnp.asarray(PX.astype(np.uint32)),
                            py=jnp.asarray(PY.astype(np.uint32)),
                            sample_index=jnp.uint32(si), seed=jnp.uint32(seed))
        tctx = ts.SampleCtx(px=torch.as_tensor(PX), py=torch.as_tensor(PY),
                            sample_index=si, seed=seed)
        for dim in DIMS:
            r1 = np.asarray(jsam.get_1d(jctx, dim))
            g1 = tsam.get_1d(tctx, dim).numpy()
            np.testing.assert_array_equal(g1.view(np.uint32),
                                          r1.view(np.uint32))
            r2 = np.asarray(jsam.get_2d(jctx, dim))
            g2 = tsam.get_2d(tctx, dim).numpy()
            np.testing.assert_array_equal(g2.view(np.uint32),
                                          r2.view(np.uint32))


def test_warps_match():
    """Disk and hemisphere warps: cos/sin may differ by an ulp between
    XLA and torch, nothing else.  The hemisphere's z = sqrt(1 - |d|^2)
    amplifies that ulp near the rim (dz = -|d| d|d| / z), so z is held
    through z^2, which the ulp moves by O(1e-7)."""
    u = np.random.default_rng(2).random((4096, 2)).astype(np.float32)
    u[0] = [0.5, 0.5]  # the degenerate centre
    ref = np.asarray(js.cosine_sample_hemisphere(jnp.asarray(u)))
    got = ts.cosine_sample_hemisphere(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got[:, :2], ref[:, :2], rtol=1e-6, atol=2e-7)
    np.testing.assert_allclose(got[:, 2] ** 2, ref[:, 2] ** 2, atol=1e-6)
    ref = np.asarray(js.concentric_sample_disk(jnp.asarray(u)))
    got = ts.concentric_sample_disk(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=2e-7)


@pytest.mark.parametrize("res", [(64, 48), (1920, 1080), (33, 100)])
def test_camera_matrices_equal(res):
    _, cam, _ = jcornell()
    a, b = JCamera.create(cam, *res), Camera.create(cam, *res)
    np.testing.assert_array_equal(a.camera_to_world, b.camera_to_world)
    np.testing.assert_array_equal(a.raster_to_camera, b.raster_to_camera)


def test_camera_ray_allclose():
    _, cam, _ = jcornell()
    a, b = JCamera.create(cam, 64, 48), Camera.create(cam, 64, 48)
    p = (np.random.default_rng(3).random((2048, 2)) * [64, 48]).astype(
        np.float32)
    oj, dj = a.ray(jnp.asarray(p))
    ot, dt = b.ray(torch.as_tensor(p))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6,
                               atol=1e-7)


def test_transform_appliers():
    m = (jtf.rotation(0.7, (1.0, 2.0, 0.5)) @ jtf.translation((1, -2, 3))
         @ jtf.scale(2.0, 0.5, 1.5))
    p = np.random.default_rng(4).standard_normal((512, 3)).astype(np.float32)
    mt = torch.as_tensor(m.m)
    for jf, tf_ in [(jtf.apply_p_jax, ttf.apply_p), (jtf.apply_v_jax,
                                                     ttf.apply_v)]:
        np.testing.assert_allclose(tf_(mt, torch.as_tensor(p)).numpy(),
                                   np.asarray(jf(jnp.asarray(m.m), p)),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        ttf.apply_n(torch.as_tensor(m.m_inv), torch.as_tensor(p)).numpy(),
        np.asarray(jtf.apply_n_jax(jnp.asarray(m.m_inv), p)),
        rtol=1e-6, atol=1e-6)
    # The host-side transform constructors are a verbatim port.
    t = ttf.look_at((1, 2, 3), (0, 0, 0), (0, 1, 0))
    j = jtf.look_at((1, 2, 3), (0, 0, 0), (0, 1, 0))
    np.testing.assert_array_equal(t.m, j.m)
    np.testing.assert_array_equal(t.m_inv, j.m_inv)


def test_film_tiles_and_image_equal():
    fs_j = jfilm.FilmSettings(res=(70, 37), tile_dim=16)
    fs_t = tfilm.FilmSettings(res=(70, 37), tile_dim=16)
    tj, tt = jfilm.film_tiles(fs_j), tfilm.film_tiles(fs_t)
    assert [(t.x0, t.y0, t.index) for t in tj] == [
        (t.x0, t.y0, t.index) for t in tt]
    fj = jfilm.Film(70, 37, 16)
    ft = tfilm.Film(70, 37, 16, device="cpu")
    rng = np.random.default_rng(5)
    for _ in range(3):
        ids = rng.permutation(fj.n_tiles + 2)[:6].astype(np.int32)
        px = rng.random((6, 16, 16, 3)).astype(np.float32)
        fj.add_tiles(jnp.asarray(ids), jnp.asarray(px))
        ft.add_tiles(torch.as_tensor(ids), torch.as_tensor(px))
    np.testing.assert_array_equal(ft.samples.numpy(), np.asarray(fj.samples))
    np.testing.assert_array_equal(ft.image(), fj.image())


@pytest.mark.parametrize("l", [1, 2, 4, 6, 9, 16, 25])
def test_permutation_element_bit_exact(l):
    """Kensler's permutation against yuki_tpu's for power-of-two and other
    lengths (rejection rounds), keys past 2^31 and i + p wrapping at 2^32.
    Indices lie in [0, l), as sample indices do: the rejection loop walks
    the cycle of a bijection of [0, w] and returns below l only from an
    index below l.  A power-of-two l accepts any index in one round."""
    rng = np.random.default_rng(l)
    i = rng.integers(0, l, 2048, dtype=np.int64)
    if l & (l - 1) == 0:
        i[::2] = rng.integers(0, 2 ** 32, 1024, dtype=np.int64)
    p = rng.integers(0, 2 ** 32, 2048, dtype=np.int64)
    p[:4] = [2 ** 31, 2 ** 32 - 1, 2 ** 32 - 2, 0]
    assert (p >= 2 ** 31).sum() > 900
    ref = np.asarray(js.permutation_element(
        jnp.asarray(i.astype(np.uint32)), l, jnp.asarray(p.astype(np.uint32))))
    got = ts.permutation_element(torch.as_tensor(i), l,
                                 torch.as_tensor(p)).numpy()
    np.testing.assert_array_equal(got, _u32(ref))
    assert got.min() >= 0 and got.max() < l


@pytest.mark.parametrize("jitter", [True, False])
@pytest.mark.parametrize("xy", [(1, 1), (2, 2), (3, 3), (4, 2)])
def test_stratified_sampler_bit_exact(xy, jitter):
    """get_1d and get_2d over dims 0-30 against yuki_tpu's, run op by op
    (under jit XLA turns the divide by a constant spp into a multiply by
    its reciprocal, an ulp off the sampler's own IEEE divide; jax's eager
    ops, like the port, divide), at the last sample of the pixel and a
    seed past 2^31 with jitter, the first sample otherwise."""
    import jax

    jsam = js.StratifiedSampler(*xy, jitter=jitter)
    tsam = ts.StratifiedSampler(*xy, jitter=jitter)
    assert tsam.samples_per_pixel == xy[0] * xy[1]
    si, seed = (tsam.samples_per_pixel - 1, 2 ** 31 + 7) if jitter else (0, 1)
    jctx = js.SampleCtx(px=jnp.asarray(PX.astype(np.uint32)),
                        py=jnp.asarray(PY.astype(np.uint32)),
                        sample_index=jnp.uint32(si), seed=jnp.uint32(seed))
    tctx = ts.SampleCtx(px=torch.as_tensor(PX), py=torch.as_tensor(PY),
                        sample_index=si, seed=seed)
    for dim in range(31):
        with jax.disable_jit():
            r1 = np.asarray(jsam.get_1d(jctx, dim))
            r2 = np.asarray(jsam.get_2d(jctx, dim))
        g1 = tsam.get_1d(tctx, dim).numpy()
        np.testing.assert_array_equal(g1.view(np.uint32), r1.view(np.uint32))
        g2 = tsam.get_2d(tctx, dim).numpy()
        assert g2.shape == r2.shape
        np.testing.assert_array_equal(g2.view(np.uint32), r2.view(np.uint32))


@pytest.mark.parametrize("make", ["uniform", "stratified"])
def test_force_single_sample(make):
    if make == "uniform":
        jsam, tsam = js.UniformSampler(16), ts.UniformSampler(16)
    else:
        jsam = js.StratifiedSampler(4, 2, symmetric_dimensions=False,
                                    jitter=False)
        tsam = ts.StratifiedSampler(4, 2, symmetric_dimensions=False,
                                    jitter=False)
    ref, got = js.force_single_sample(jsam), ts.force_single_sample(tsam)
    assert type(got).__name__ == type(ref).__name__
    assert got.samples_per_pixel == ref.samples_per_pixel == 1
    assert vars(got) == vars(ref)
