"""The dense bounce's plain version is lane-permutation equivariant bit for
bit: permuting its input planes, the sampler hash ``ph`` and the
stratified planes permutes every output plane and changes no bit.

The bounce kernel relies on it: it runs each tile's lanes grouped by
material class, each lane reading and writing its own index, and is held
bit for bit against the plain version (and against its film-order run) on
the card.  Here, on the CPU, the property is checked on the plain version
itself, on each scene of tests/test_torch_cuda.py's CASES, at every bounce
and under both samplers.
"""

import numpy as np
import pytest
import torch

from test_torch_cuda import CASES, DEPTH, N, _setup
from yuki_tpu_torch.ops import path_fused as tpf
from yuki_tpu_torch.sampling import StratifiedSampler

torch.set_num_threads(2)


@pytest.mark.parametrize("sampler", ["uniform", "stratified"])
@pytest.mark.parametrize("name,clamp", CASES)
def test_bounce_plain_is_lane_permutation_equivariant(name, clamp, sampler):
    tb, px, py = _setup(name, torch.device("cpu"), clamp)
    sam = StratifiedSampler(2, 2) if sampler == "stratified" else None
    spl = tpf.strat_planes(sam, px, py, 3, 11, tb.n_lights, DEPTH)
    st, ph = tpf.raygen_trace_plain(px, py, 3, 11, tb,
                                    None if spl is None else spl[:2])
    perm = torch.as_tensor(np.random.default_rng(5).permutation(N))
    seen = {"dead": 0, "missed": 0, "hit": 0}
    for b in range(DEPTH):
        alive = st[tpf._ST["alive"]] > 0.0
        hitf = st[tpf._ST["hitf"]] > 0.0
        seen["dead"] += int((~alive).sum())
        seen["missed"] += int((alive & ~hitf).sum())
        seen["hit"] += int((alive & hitf).sum())
        planes = tpf._bounce_planes(spl, tb, b)
        out = tpf.bounce_plain(st, ph, b, tb, planes)
        out_p = tpf.bounce_plain(
            st[:, perm].contiguous(), ph[perm].contiguous(), b, tb,
            None if planes is None else planes[:, perm].contiguous())
        assert torch.equal(out_p.view(torch.int32),
                           out[:, perm].view(torch.int32)), f"bounce {b}"
        st = out
    # The bounces took dead, missed and live lanes.
    assert min(seen.values()) > 0, seen
