"""The port's treelet dispatch against yuki_tpu.traverse: occlusion, plainly
and with an overflow re-run.  A file of its own because yuki_tpu compiles
its whole dispatch in interpret mode for each call; see
test_torch_dispatch.py."""

import torch

from test_torch_dispatch import check_dispatch, soup  # noqa: F401

torch.set_num_threads(2)


def test_any_dispatch_matches_jax(soup, monkeypatch):
    check_dispatch(soup, "any", monkeypatch, ("plain", "overflow"))
