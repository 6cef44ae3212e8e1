"""The plain skip-light closest walks of the port against yuki_tpu's
kernels, bit for bit: the dense skip sweep (``_dense_skip_kernel``) and
the ``with_skip`` variant of the row-union walk (``rows_closest_w``); the
slot walk's and the bundle walk's are in test_torch_skip_walks_stream.py
(one file each would pass a minute on one worker).

yuki_tpu's grid kernels run step by step and op by op
(torch_parity.eager_grid_pallas): Pallas interpret mode is compiled by
XLA, which contracts a*b + c into FMAs, where the port rounds every
product as its CUDA kernels do.  So t, prim and overflow are held bit for
bit.  The dense query path (yuki_tpu's intersect_dense with skip_light,
whose Pallas kernel torch_parity.jax_dense_kernels runs in interpret
mode) is held on prim exactly and on t to rtol 2e-5 (that FMA
contraction, as tests/test_torch_dispatch.py states it).

Inputs: a 900-triangle soup in 16-triangle chunks whose rows carry light
ids -1, 0 and 1; divergent rays (an eighth axis-parallel from chunk-box
corners, half aimed at triangle centroids, a fifth parked with t_max 0)
with skip ids -2 (matches nothing), -1 (every triangle that is not an
area light), 0 and 1.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from test_torch_dense import _inputs, _Out, _planes
from yuki_tpu import traverse as jtr
from yuki_tpu.ops import trace as jtrace
from yuki_tpu.ops import trace_rows as jrows
from yuki_tpu.ops import trace_stream as jts
from yuki_tpu_torch import traverse
from yuki_tpu_torch.ops import trace as ttrace
from yuki_tpu_torch.ops import trace_rows as trows
from yuki_tpu_torch.ops.trace import F32_MAX

torch.set_num_threads(2)

N = 256
N_TRIS = 900


@pytest.fixture(scope="module")
def soup():
    light = np.random.default_rng(5).integers(-1, 2, N_TRIS).astype(np.int32)
    return tp.chunk_soup(N_TRIS, 23, 16, light=light)


def _rays(soup, seed, n=N):
    _, _, _, tch = soup
    o, d = tp.divergent_rays(n, seed, tch.treelet_bounds.numpy())
    rng = np.random.default_rng(seed)
    rows = tch.rows.numpy()
    cent = rows[rows[:, 10] >= 0, :9].reshape(-1, 3, 3).mean(axis=1)
    aim = cent[rng.integers(0, cent.shape[0], n // 2)] - o[1::2]
    d[1::2] = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    t_max = np.full(n, F32_MAX, np.float32)
    t_max[rng.random(n) < 0.2] = 0.0
    skip = rng.choice([-2, -1, 0, 1], n).astype(np.int32)
    return o, d, t_max, skip


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.as_tensor(np.asarray(x)) for x in xs]


def _assert_equal(ref, got, *names):
    for r, g, name in zip(ref, got, names):
        r, g = np.asarray(r), g.numpy()
        if r.dtype == np.float32:
            r, g = r.view(np.uint32), g.view(np.uint32)
        np.testing.assert_array_equal(g, r, err_msg=name)


def _skipped_somewhere(prim_skip, prim_plain):
    """The skip changed some answers (else the test would not test it)."""
    assert (prim_skip != prim_plain).any()


@pytest.mark.parametrize("n_tris", [36, 1500])
def test_dense_skip_kernel_matches_jax(n_tris):
    """_dense_skip_kernel's body op by op against dense_trace_skip_plain
    (yuki_tpu's static unroll at T = 36, its fori_loop at T = 1500)."""
    packed, light, o, d, t_max, skip = _inputs(n_tris, 5)
    skip[::5] = -1
    outs = [_Out() for _ in range(4)]
    with tp.eager_grid_pallas():
        jtrace._dense_skip_kernel(
            jnp.asarray(packed), jnp.asarray(light[:, None]),
            *_planes(o, d, t_max), jnp.asarray(skip.reshape(-1, 128)), *outs,
            n_tris=n_tris)
    got = ttrace.dense_trace_skip(*_t(packed, light, o, d, t_max, skip))
    _assert_equal([r.value for r in outs], got, "t", "prim", "b0", "b1")
    plain = ttrace.dense_trace(*_t(packed, o, d, t_max))
    _skipped_somewhere(got[1].numpy(), plain[1].numpy())
    assert ttrace.LAUNCHES["dense_closest_skip"] == 0  # CPU: plain version


def test_dense_skip_query_matches_jax():
    """yuki_tpu's intersect_dense(skip_light=...) with its Pallas kernel in
    interpret mode against the port's, on a lit 1500-triangle soup."""
    jsc, tsc = tp.soup_scenes(1500, 9, lit=True)
    assert tsc.meta.traversal == "dense"
    rng = np.random.default_rng(9)
    o = ((rng.random((N, 3)) - 0.5) * 6).astype(np.float32)
    d = rng.standard_normal((N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(np.arange(N) % 2 == 0, F32_MAX, 2.5).astype(np.float32)
    skip = np.where(np.arange(N) % 2 == 0, -2, 0).astype(np.int32)
    with tp.jax_dense_kernels():
        ref = jtr.intersect_dense(jsc.data, *_j(o, d, t_max),
                                  skip_light=jnp.asarray(skip))
    got = traverse.intersect_dense(tsc.data, *_t(o, d, t_max),
                                   skip_light=torch.as_tensor(skip))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=2e-5)
    hit = got[1].numpy() >= 0
    assert hit[::2].sum() > N // 8 and hit[1::2].any()


@pytest.mark.parametrize("C", [160, 8])
def test_rows_skip_matches_jax(soup, C):
    """The row walk's with_skip variant over the rows' exact union words
    (at the dispatch's C = 160, and at C = 8, which cuts every row's list:
    overflow)."""
    _, jch, _, tch = soup
    o, d, t_max, skip = _rays(soup, 3)
    words = np.asarray(jrows.row_words_of(jts._cross_words_xla(
        jch, *_j(o, d, t_max)), N // 128))
    with tp.eager_grid_pallas():
        ref = jrows.rows_closest_w(jch, jnp.asarray(words), *_j(o, d, t_max),
                                   C=C, mult=128, interpret=True,
                                   skip_light=jnp.asarray(skip))
    tw_ = torch.as_tensor(words.astype(np.int64))
    got = trows.rows_closest_w(tch, tw_, *_t(o, d, t_max), C=C, mult=128,
                               skip=torch.as_tensor(skip))
    _assert_equal(ref, got, "t", "prim", "overflow")
    assert got[2].all() == (C == 8)
    plain = trows.rows_closest_w(tch, tw_, *_t(o, d, t_max), C=C, mult=128)
    _skipped_somewhere(got[1].numpy(), plain[1].numpy())
