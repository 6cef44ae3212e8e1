"""The chunking contract of the block-pair walks (tests/test_pairs.py
TestChunking): yuki_tpu's pairs_closest / pairs_any in 16-pair launches,
so that both ray blocks split across launches and merge by the strict
min-t, against the port's one walk per block, bit for bit, on
test_torch_pairs.py's soup, rays and pair list (yuki_tpu's kernels op by
op under torch_parity.eager_grid_pallas).
"""

import torch

from test_torch_pairs import (_assert_walks_equal, _both, _rays, _t,
                              soup)  # noqa: F401
from yuki_tpu_torch.ops import trace_pairs as tpp

torch.set_num_threads(2)


def test_chunking_does_not_change_the_walks(soup, monkeypatch):
    """yuki_tpu in 16-pair launches (both blocks split across launches,
    merged by the strict min-t) against the port's one walk per block."""
    jtl, ttl = soup
    o, d, t_max, _ = _rays(ttl, 3)
    n_pairs = tpp.block_candidate_pairs(ttl, *_t(o, d, t_max), 1)[2]
    ref_c, got_c, ref_a, got_a = _both(soup, 3, max_pairs=n_pairs + 15,
                                       chunk=16, monkeypatch=monkeypatch)
    pb = tpp.block_candidate_pairs(ttl, *_t(o, d, t_max), n_pairs)[0]
    runs = tpp.pair_runs(pb, n_pairs, 2)
    assert (runs[1:] - runs[:-1] > 16).all()  # every block spans launches
    _assert_walks_equal(ref_c, got_c, ref_a, got_a)
