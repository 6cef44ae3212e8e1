"""The port's treelet dispatch against yuki_tpu.traverse on a coherent
wave, which both send to the row-union engine: occlusion, plainly and with
rows cut at a list width of 2, whose rays re-run through the wide pass.
A file of its own because yuki_tpu compiles its whole dispatch in
interpret mode for each call; see test_torch_dispatch.py."""

import torch

from test_torch_dispatch import check_dispatch, soup  # noqa: F401

torch.set_num_threads(2)


def test_any_rows_dispatch_matches_jax(soup, monkeypatch):
    check_dispatch(soup, "any", monkeypatch, ("plain", "overflow"),
                   rays="coherent")
