"""A ``StratifiedSampler``'s draws in one launch: ``csrc/sampling.cu``.

A stratified value depends only on (seed, pixel, sample index,
dimension), so a list of draws for every lane is integer work that needs
nothing from the path.  ``strat_draws`` takes such a list, each draw a
``(dim, k)`` pair (``k`` = 1 for ``get_1d``'s value, 2 for ``get_2d``'s
pair), and returns its f32 planes in the list's order.  CUDA lanes always
take one launch of ``strat_draws_kernel`` (added, no TPU twin:
``yuki_tpu`` computes these values as XLA ops), with no host read; their
sample index and seed are one integer for all lanes (a tensor key raises
``TypeError``).  Each launch adds one to ``LAUNCHES``, and the draws it
serves to ``sampling.draws_kernel``.

CPU lanes take the sampler's torch code, the kernel's plain twin
(``StratifiedSampler.plain_1d`` / ``plain_2d``, counted in
``sampling.draws_plain``), which also takes per-lane tensor keys.  The
kernel runs the same u32 maths with native wrapping and Kensler's
rejection per lane until it accepts, which gives the torch version's
bits: an extra round never changes an accepted lane.
"""

from __future__ import annotations

import ctypes
import operator

import torch

from ..profiling import COUNTS, pass_scope
from . import _build

MAX_DRAWS = 256  # draws a launch: the kernel's parameter block (sampling.cu)

# Kernel launches since the last reset_launches().
LAUNCHES = {"strat_draws": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_keys(ctx) -> tuple[int, int]:
    """The kernel's u32 sample index and seed for ``ctx``'s lanes: each an
    integer (``operator.index``; a tensor raises ``TypeError``), and
    ``px``, ``py`` one shape (else ``ValueError``)."""
    keys = []
    for name in ("sample_index", "seed"):
        v = getattr(ctx, name)
        if isinstance(v, torch.Tensor):
            raise TypeError(f"the draws kernel takes one integer {name} for "
                            f"all lanes, not a tensor")
        keys.append(operator.index(v) & 0xFFFFFFFF)
    if ctx.px.shape != ctx.py.shape:
        raise ValueError(f"px {tuple(ctx.px.shape)} and py "
                         f"{tuple(ctx.py.shape)} differ in shape")
    return keys[0], keys[1]


def strat_draws(sampler, ctx, draws):
    """The planes of ``draws`` ((dim, k) pairs) for every lane of ``ctx``:
    f32 [planes, *px.shape].  The kernel for CUDA lanes, else
    ``strat_draws_plain``."""
    draws = tuple((int(dim), int(k)) for dim, k in draws)
    if any(k not in (1, 2) or not 0 <= dim < 2 ** 31 for dim, k in draws):
        raise ValueError(f"draws are (dim in [0, 2^31), 1 or 2): {draws}")
    with pass_scope("sampling.stratified"):
        if ctx.px.device.type != "cuda":
            return strat_draws_plain(sampler, ctx, draws)
        out = _launch(sampler, ctx, draws)
    return out.reshape((out.shape[0],) + tuple(ctx.px.shape))


def _launch(sampler, ctx, draws):
    """The kernel over the flattened lanes (one launch a MAX_DRAWS
    draws): f32 [planes, N]."""
    sample_index, seed = kernel_keys(ctx)
    dev = ctx.px.device
    px = ctx.px.reshape(-1).to(torch.int32).contiguous()
    py = ctx.py.reshape(-1).to(torch.int32).contiguous()
    n = px.shape[0]
    _build.bump(COUNTS, "sampling.draws_kernel", len(draws))
    out = torch.empty((sum(k for _, k in draws), n), dtype=torch.float32,
                      device=dev)
    if n == 0 or not draws:
        return out
    codes = (ctypes.c_uint32 * len(draws))(
        *((dim << 1) | (k - 1) for dim, k in draws))
    err = _build.library().yk_strat_draws(
        dev.index, _build.ptr(px), _build.ptr(py), n,
        ctypes.c_uint32(sample_index), ctypes.c_uint32(seed),
        sampler.pixel_samples_x, sampler.pixel_samples_y, int(sampler.jitter),
        codes, len(draws), _build.ptr(out), _build.stream(dev))
    _build.launch_check(err, "strat_draws")
    _build.bump(LAUNCHES, "strat_draws", -(-len(draws) // MAX_DRAWS))
    return out


def strat_draws_plain(sampler, ctx, draws):
    """Plain version of ``strat_draws``: the sampler's torch values."""
    vals = []
    for dim, k in draws:
        if k == 1:
            vals.append(sampler.plain_1d(ctx, dim))
        else:
            vals += list(sampler.plain_2d(ctx, dim).unbind(-1))
    return torch.stack(vals)
