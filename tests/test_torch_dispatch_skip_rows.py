"""test_torch_dispatch_skip.py's check on a coherent combined wave:
camera-like closest lanes and short shadow segments, which both packages
take through the rows engine (the with_skip row walk), sorted by
ray_sort_key first (skip_sort False, yuki_tpu's default), bary_count
unset."""

import torch

from test_torch_dispatch_skip import check_skip_dispatch, soup  # noqa: F401

torch.set_num_threads(2)


def test_skip_dispatch_matches_jax_coherent(soup):
    check_skip_dispatch(soup, coherent=True, skip_sort=False)
