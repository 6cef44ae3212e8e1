"""The strat variants of the dense wave's raygen and bounce bodies
(StratifiedSampler(2, 2)'s planes) against yuki_tpu's (_raygen_values
with jitter planes, _bounce_values with urand planes) from the same state,
under test_torch_path_fused.py's rules.  The whole stratified wave is in
test_torch_wave_strat.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_path_fused import (CLOSE, EXACT, N, _bounce_dict, _i32,
                                   _jax_states, _pixels, _setup, _to_state,
                                   xla_transcendentals)  # noqa: F401
from yuki_tpu.ops import path_fused as jpf
from yuki_tpu_torch.ops import path_fused as tpf
from yuki_tpu_torch.sampling import StratifiedSampler

torch.set_num_threads(2)

SI, SEED = 3, 2 ** 31 + 7  # _jax_states' sample and seed (SI < 4)


def _planes(name):
    """StratifiedSampler(2, 2)'s planes for _jax_states' 1024 pixels."""
    _, _, tb = _setup(name)
    px, py = (torch.as_tensor(x) for x in _pixels(11))
    return px, py, tpf.strat_planes(StratifiedSampler(2, 2), px, py, SI,
                                    SEED, tb.n_lights, tb.max_depth)


def _jax_block(x):
    return jnp.asarray(x.numpy().reshape(8, 128))


def test_strat_raygen_matches_jax():
    name = "cornell"
    _, jt, tb = _setup(name)
    px, py, spl = _planes(name)
    s = jt["statics"]
    ph_ref, stv = jpf._raygen_values(
        _jax_block(px), _jax_block(py), _i32(SI), _i32(SEED), jt["ms"],
        jt["tri"], jt["sp"], n_tris=s["n_tris"], n_spheres=s["n_spheres"],
        jitter=(_jax_block(spl[0]), _jax_block(spl[1])))
    st, ph = tpf.raygen_trace(px, py, SI, SEED, tb, spl[:2])
    np.testing.assert_array_equal(ph.numpy(), np.asarray(ph_ref).reshape(-1))
    for k in ("prim", "sph", "hitf"):
        np.testing.assert_array_equal(st[tpf._ST[k]].numpy(),
                                      np.asarray(stv[k]).reshape(-1), k)
    for k in ("ox", "oy", "oz", "dx", "dy", "dz", "t", "b0", "b1"):
        np.testing.assert_allclose(st[tpf._ST[k]].numpy(),
                                   np.asarray(stv[k]).reshape(-1),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    uni, _ = tpf.raygen_trace(px, py, SI, SEED, tb)
    assert not torch.equal(uni[tpf._ST["dx"]], st[tpf._ST["dx"]])


@pytest.mark.parametrize("bounce_index", [0, 2])
def test_strat_bounce_matches_jax(bounce_index, xla_transcendentals):
    """One bounce from the same JAX state with the bounce's 2L+3 planes:
    liveness, specular flag and ray count exact, the rest to rtol 2e-6 /
    atol 1e-7 (cos/sin/log evaluated by XLA on both sides)."""
    name = "cornell"
    _, jt, tb = _setup(name)
    s = jt["statics"]
    ph, states = _jax_states(name)
    stv, _ = states[bounce_index]
    _, _, spl = _planes(name)
    planes = tpf._bounce_planes(spl, tb, bounce_index)
    ref = _bounce_dict(jpf._bounce_values(
        jnp.int32(2 + bounce_index * tb.dims_per_bounce),
        jnp.int32(bounce_index), lambda k: stv[k],
        jnp.asarray(ph.numpy().reshape(8, 128)), jt["ms"], jt["tri"],
        jt["trs"], jt["trb"], jt["matb"], jt["lt"], jt["sp"], jt["td"],
        jt["tex"], jt["pal"], max_depth=tb.max_depth,
        urand=lambda k: _jax_block(planes[k]), **s))
    out = tpf.bounce(_to_state(stv), ph, bounce_index, tb, planes)
    for k in EXACT:
        np.testing.assert_array_equal(out[tpf._ST[k]].numpy(),
                                      np.asarray(ref[k]).reshape(-1), k)
    for k in CLOSE:
        np.testing.assert_allclose(out[tpf._ST[k]].numpy(),
                                   np.asarray(ref[k]).reshape(-1),
                                   rtol=2e-6, atol=1e-7, err_msg=k)
    uni = tpf.bounce(_to_state(stv), ph, bounce_index, tb)
    assert not torch.equal(uni[tpf._ST["dx"]], out[tpf._ST["dx"]])
    assert out[tpf._ST["alive"]].sum() >= N // 8
