"""The row-union engine's plain occlusion walk against
yuki_tpu.ops.trace_rows, bit for bit, on the cases of test_torch_rows.py:
live rays carry a 9.0 chord (through the soup) and a skip light id of -2,
-1 or 0 (the soup has no area light, so -1 and 0 skip nothing real and
-2 is the closest lanes' id).  Overflow flags must be equal everywhere, occlusion on every
ray that did not overflow."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from test_torch_rows import (CASES, assert_overflow_mix, rows_inputs,
                             trap_chunk, with_case)
from yuki_tpu.ops import trace_rows as jrows
from yuki_tpu_torch.ops import trace_rows as trows

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def soup():
    return tp.chunk_soup(500, 11, 16)


@pytest.mark.parametrize("case", list(CASES))
def test_rows_any_matches_jax(soup, case, monkeypatch):
    _, jch, _, tch = soup
    jargs, targs = rows_inputs(soup, case, 1, t_chord=9.0)
    skip = np.random.default_rng(1).choice([-2, -1, 0], targs[1].shape[0])
    skip = skip.astype(np.int32)

    def run(C, mult):
        with tp.eager_grid_pallas():
            ref = jrows.rows_any_w(jch, *jargs, jnp.asarray(skip), C=C,
                                   mult=mult, interpret=True)
        return ref, trows.rows_any_w(tch, *targs, torch.as_tensor(skip), C=C,
                                     mult=mult)

    (occ_r, ov_r), (occ, ov) = with_case(monkeypatch, case, run)
    occ_r, ov_r, occ, ov = (np.asarray(x) for x in (occ_r, ov_r, occ, ov))
    np.testing.assert_array_equal(ov, ov_r)
    assert_overflow_mix(case, ov)
    keep = ~ov
    np.testing.assert_array_equal(occ[keep], occ_r[keep])
    assert occ[keep].any() and not occ[keep].all()
    if case == "empty_rows":
        # The forced pair alone (chunk 0) occludes rays of rows 2 and 5.
        assert occ.reshape(-1, 128)[[2, 5]].any()


def test_rows_any_traps():
    """The occlusion walk leaves a chunk for the whole row after the first
    group of 8 at which no crossing lane is unoccluded: in row 0, B (the
    only crossing lane) is occluded by triangle 0, so the row stops before
    triangle 8 and lane A (not crossing: its recheck is NaN) stays
    unoccluded; in row 2, C is not occluded by group 0, the row walks
    group 1 and triangle 8 occludes A and C; alone (row 1), A enters no
    chunk.  Equal to yuki_tpu's kernel."""
    jch, tch, words, o, d, t_max = trap_chunk()
    skip = np.full(o.shape[0], -2, np.int32)
    with tp.eager_grid_pallas():
        occ_r, ov_r = jrows.rows_any_w(
            jch, *(jnp.asarray(x) for x in (words, o, d, t_max, skip)), C=4,
            mult=4, interpret=True)
    occ, ov = trows.rows_any_w(
        tch, torch.as_tensor(words.astype(np.int64)), *(
            torch.as_tensor(x) for x in (o, d, t_max, skip)), C=4, mult=4)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_r))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(ov_r))
    assert occ[[0, 1, 128, 256, 257]].tolist() == [False, True, False, True,
                                                   True]
