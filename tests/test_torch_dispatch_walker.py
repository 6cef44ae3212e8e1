"""The port's treelet dispatch with the bundle walker on (traverse.
WALKER_CLOSEST / WALKER_ANY) against yuki_tpu's with the same flags, under
FORCE_PALLAS_INTERPRET (the test_torch_dispatch.py pattern), on divergent
rays, so that both take the divergent branch and walk bundles: plainly,
and with the port's walker lists cut at C = 2, so that many rays re-run
through the crossing words and the wide pass (yuki_tpu's answers do not
depend on C, so one yuki_tpu call serves both).  prim, hit and occlusion
equal; t to rtol 2e-5 and b0/b1 to atol 1e-5, as interpret mode contracts
FMAs (test_torch_dispatch.assert_dispatch_agrees).  The flags are restored
in ``finally``; the treelet walk must not run.  yuki_tpu compiles its
dispatch for each query (about a minute for intersect), so occlusion lives
in test_torch_dispatch_walker_any.py."""

import functools

import torch

from test_torch_dispatch import (N, _no_walk, assert_dispatch_agrees,
                                 dispatch_rays, jax_dispatch, port_dispatch,
                                 soup)  # noqa: F401
from yuki_tpu import traverse as jtr
from yuki_tpu_torch import traverse
from yuki_tpu_torch.ops import trace_walker as tw

torch.set_num_threads(2)


def _set_walker(on: bool) -> None:
    jtr.WALKER_CLOSEST = jtr.WALKER_ANY = on
    traverse.WALKER_CLOSEST = traverse.WALKER_ANY = on


def check_walker_dispatch(soup, query, monkeypatch):
    jsc, tsc = soup
    rays = dispatch_rays(tsc, seed=5)
    name = f"walker_{query}_w"
    try:
        _set_walker(True)
        ref = jax_dispatch(jsc, query, *rays)
        for case in ("plain", "overflow"):
            with monkeypatch.context() as m:
                if case == "overflow":
                    m.setattr(traverse, name, functools.partial(
                        getattr(tw, name), C=2))
                for walk in ("treelet_closest", "treelet_any"):
                    m.setattr(traverse, walk, _no_walk)
                traverse.reset_counts()
                got = port_dispatch(tsc, query, *rays)
            assert_dispatch_agrees(query, ref, got)
            c = traverse.counts()
            assert c[f"{query}_walker"] == 1 and c[f"{query}_slot"] == 0
            assert c["fallbacks"] == 0
            assert (c["wide_reruns"] == 1) == (case == "overflow")
            if case == "overflow":
                assert c["overflow_rays"] > N // 8
    finally:
        _set_walker(False)


def test_walker_closest_dispatch_matches_jax(soup, monkeypatch):
    check_walker_dispatch(soup, "closest", monkeypatch)
