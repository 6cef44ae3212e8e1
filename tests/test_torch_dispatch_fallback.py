"""The port's treelet dispatch against yuki_tpu.traverse: the closest query
when the slot budget blows and both fall back to the treelet walk.  A file
of its own because yuki_tpu compiles its whole dispatch in interpret mode
for each call; see test_torch_dispatch.py."""

import torch

from test_torch_dispatch import check_dispatch, soup  # noqa: F401

torch.set_num_threads(2)


def test_closest_dispatch_falls_back_like_jax(soup, monkeypatch):
    check_dispatch(soup, "closest", monkeypatch, ("fallback",))
