"""The dense sweeps' plain versions (yuki_tpu_torch/ops/trace.py
dense_trace_plain, any_trace_plain) against yuki_tpu.ops.trace's
_dense_kernel and _any_kernel, bit for bit.

yuki_tpu's kernel bodies run op by op on [rows, 128] planes (the loop over
triangles as a Python loop: interpret mode would let XLA contract FMAs),
at T = 36 (the statically unrolled branch, T <= UNROLL_TRIS) and T = 1500
(the fori_loop branch).  The rays: 512 from the soup's box, half at a
triangle's centroid, the rest in random directions or axis-parallel, a
seventh parked with t_max 0, a fifth with a finite chord; triangles carry
light ids -1, 0 and 1, and the lanes skip -2, 0 or 1.  t, prim, b0, b1
and occlusion must be equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from yuki_tpu.ops import trace as jtrace
from yuki_tpu_torch.ops import trace as ttrace
from yuki_tpu_torch.ops.trace import F32_MAX, pack_triangles

torch.set_num_threads(2)

N = 512


class _Out:
    """A kernel output ref: keeps what ``ref[:] = value`` writes."""

    def __setitem__(self, _, value):
        self.value = np.asarray(value).reshape(-1)


def _inputs(n_tris, seed):
    tri = tp.soup_triangles(n_tris, seed)  # [T, 3, 3]
    packed = np.zeros((n_tris, 12), np.float32)
    packed[:, :9] = tri.reshape(n_tris, 9)
    light = np.random.default_rng(seed).choice([-1, -1, 0, 1], n_tris)
    o, d = tp.divergent_rays(N, seed, tri.reshape(-1, 3))
    rng = np.random.default_rng(seed + 1)
    aim = np.arange(N) % 2 == 1  # at a triangle's centroid
    d[aim] = tri.mean(axis=1)[rng.integers(0, n_tris, aim.sum())] - o[aim]
    d[aim] /= np.linalg.norm(d[aim], axis=1, keepdims=True)
    t_max = np.full(N, F32_MAX, np.float32)
    t_max[rng.random(N) < 0.2] = 2.0
    t_max[np.arange(N) % 7 == 3] = 0.0
    skip = rng.choice([-2, 0, 1], N).astype(np.int32)
    return packed, light.astype(np.int32), o, d, t_max, skip


def _planes(o, d, t_max):
    return [jnp.asarray(x.reshape(-1, 128)) for x in
            (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t_max)]


@pytest.mark.parametrize("n_tris", [36, 1500])
def test_dense_trace_matches_jax(n_tris):
    packed, light, o, d, t_max, skip = _inputs(n_tris, 5)
    outs = [_Out() for _ in range(4)]
    with tp.eager_grid_pallas():
        jtrace._dense_kernel(jnp.asarray(packed), *_planes(o, d, t_max),
                             *outs, n_tris=n_tris)
    got = ttrace.dense_trace(torch.as_tensor(packed), torch.as_tensor(o),
                             torch.as_tensor(d), torch.as_tensor(t_max))
    for g, r, name in zip(got, outs, ("t", "prim", "b0", "b1")):
        np.testing.assert_array_equal(g.numpy(), r.value, err_msg=name)
    prim = got[1].numpy()
    assert (prim >= 0).sum() > N // 4 and (prim < 0).any()

    occ_ref = _Out()
    with tp.eager_grid_pallas():
        jtrace._any_kernel(jnp.asarray(packed), jnp.asarray(light[:, None]),
                           *_planes(o, d, t_max), jnp.asarray(
                               skip.reshape(-1, 128)), occ_ref, n_tris=n_tris)
    occ = ttrace.any_trace(torch.as_tensor(packed), torch.as_tensor(light),
                           torch.as_tensor(o), torch.as_tensor(d),
                           torch.as_tensor(t_max), torch.as_tensor(skip))
    np.testing.assert_array_equal(occ.numpy(), occ_ref.value)
    assert occ.any() and not occ.all()


def test_pack_triangles_layout():
    tri = torch.as_tensor(tp.soup_triangles(5, 1))
    packed = pack_triangles(tri[:, 0], tri[:, 1], tri[:, 2])
    assert packed.shape == (5, 12) and packed.is_contiguous()
    assert torch.equal(packed[:, :9], tri.reshape(5, 9))
    assert (packed[:, 9:] == 0).all()
