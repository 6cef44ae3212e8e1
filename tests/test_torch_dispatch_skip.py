"""The port's treelet dispatch with a per-lane skip light (intersect(
skip_light=..., bary_count=...)) against yuki_tpu.traverse.intersect with
traverse.FORCE_PALLAS_INTERPRET, on a combined wave of a lit treelet soup
(test_torch_combined.combined_wave: 512 closest lanes with skip -2, 512
shadow lanes with skip 0 or -2 and the 0.9999 chord): here a divergent
wave, which both take through the slot stream, with skip_sort=True as the
combined design called it; test_torch_dispatch_skip_rows.py holds a
coherent one through the rows engine, sorted by ray_sort_key (skip_sort
False, yuki_tpu's default).  yuki_tpu compiles its whole dispatch for each
call, so one wave a file.

hit and prim must be equal apart from counted ties (two triangles whose t
are within 2e-5 of each other; measured none); t is held to rtol 2e-5
and b0/b1 (on the closest lanes, the first bary_count) to atol 1e-5:
yuki_tpu's kernels run in interpret mode, which XLA compiles and may
contract into FMAs, as tests/test_torch_dispatch.py states it (measured
at most 28 ulps on the divergent wave, 3 on the coherent one; the
port's own walks are held bit for bit in test_torch_skip_walks*.py).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from test_torch_combined import N, combined_wave
from yuki_tpu import traverse as jtr
from yuki_tpu_torch import traverse
from yuki_tpu_torch.scene.data import DENSE_TRI_THRESHOLD

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def soup():
    jsc, tsc = tp.soup_scenes(DENSE_TRI_THRESHOLD + 64, 3, lit=True)
    assert dataclasses.asdict(tsc.meta) == dataclasses.asdict(jsc.meta)
    return jsc, tsc


def check_skip_dispatch(soup, coherent, skip_sort):
    jsc, tsc = soup
    o, d, t, skip = combined_wave(tsc, 5, coherent)
    old = jtr.FORCE_PALLAS_INTERPRET
    jtr.FORCE_PALLAS_INTERPRET = True
    try:
        ref = jtr.intersect(jsc.data, jsc.meta,
                            *(jnp.asarray(x.numpy()) for x in (o, d, t)),
                            skip_sort=skip_sort,
                            skip_light=jnp.asarray(skip.numpy()),
                            bary_count=N if skip_sort else None)
    finally:
        jtr.FORCE_PALLAS_INTERPRET = old
    ref = type(ref)(*(np.asarray(x) for x in ref))
    traverse.reset_counts()
    got = traverse.intersect(tsc.data, tsc.meta, o, d, t, skip,
                             skip_sort=skip_sort,
                             bary_count=N if skip_sort else None)
    got = type(got)(*(x.numpy() for x in got))
    c = traverse.counts()
    assert c["closest_rows" if coherent else "closest_slot"] == 1
    assert c["fallbacks"] == 0

    near = np.abs(got.t - ref.t) <= 2e-5 * np.abs(ref.t)
    ties = got.prim != ref.prim
    assert (near | ~ties).all() and ties.sum() <= 2
    np.testing.assert_array_equal(got.hit, ref.hit)
    np.testing.assert_allclose(got.t, ref.t, rtol=2e-5)
    same = ~ties & (got.prim >= 0)
    same[N:] = False
    for f in ("b0", "b1"):
        np.testing.assert_allclose(getattr(got, f)[same],
                                   getattr(ref, f)[same], atol=1e-5)
        if skip_sort:
            assert not getattr(got, f)[N:].any()
    shadow_hit = got.hit[N:]
    assert shadow_hit.any() and not shadow_hit.all()
    assert (got.prim[:N] >= 0).sum() > N // 4


def test_skip_dispatch_matches_jax_divergent(soup):
    check_skip_dispatch(soup, coherent=False, skip_sort=True)
