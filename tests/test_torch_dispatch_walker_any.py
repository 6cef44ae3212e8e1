"""The port's occlusion dispatch with the bundle walker on against
yuki_tpu's (test_torch_dispatch_walker.py's check, for any_intersect)."""

import torch

from test_torch_dispatch import soup  # noqa: F401
from test_torch_dispatch_walker import check_walker_dispatch

torch.set_num_threads(2)


def test_walker_any_dispatch_matches_jax(soup, monkeypatch):
    check_walker_dispatch(soup, "any", monkeypatch)
