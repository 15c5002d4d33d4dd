"""Decorrelation / recorrelation transforms (paper §IV "Decorrelation").

Two predictor families, each with 1-D and n-D variants:

* **Lorenzo** (HSZp / HSZp-nd): ``p = (I - S_0)(I - S_1)...q`` where ``S_a`` is
  the unit shift along axis ``a`` (zero boundary); recorrelation is a prefix
  sum along every axis.
* **Block-mean** (HSZx / HSZx-nd): ``p_i = q_i - M_b`` with the *rounded block
  mean* ``M_b = round(mean(q | block b))`` stored as metadata.

All integer arithmetic is int32 and wraps modulo 2^32 like the reference:
torch promotes int32 sums and prefix sums to int64, so every reduction here
names its dtype or casts back with ``.to(torch.int32)``.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch

from . import blocking


def _shift_diff(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``x - shift(x)`` along ``axis`` with zero boundary (first slice kept)."""
    out = x.clone()
    n = x.shape[axis]
    out.narrow(axis, 1, n - 1).sub_(x.narrow(axis, 0, n - 1))
    return out


def lorenzo(q: torch.Tensor) -> torch.Tensor:
    """n-D Lorenzo transform: residuals ``p`` from quantized data ``q``."""
    p = q
    for axis in range(q.ndim):
        p = _shift_diff(p, axis)
    return p


def unlorenzo(p: torch.Tensor, ndim: int | None = None) -> torch.Tensor:
    """Inverse Lorenzo: prefix-sum along every axis (int32, modular); with
    ``ndim``, along the trailing ``ndim`` axes only (leading ones a batch)."""
    q = p
    for axis in range(p.ndim - (p.ndim if ndim is None else ndim), p.ndim):
        q = torch.cumsum(q, dim=axis, dtype=torch.int32)
    return q


def block_means(q: torch.Tensor, block: Sequence[int],
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """Rounded per-block integer means, grid layout.

    ``valid`` is an optional boolean spatial mask; means are taken over valid
    elements only so padding never biases stage-① statistics.
    """
    blocked = blocking.to_blocked(q, block)
    nd = len(block)
    reduce_axes = tuple(range(nd, 2 * nd))
    if valid is None:
        counts = 1
        for b in block:
            counts *= b
        sums = blocked.sum(dim=reduce_axes, dtype=torch.int64).to(torch.int32)
    else:
        vb = blocking.to_blocked(valid.to(torch.int32), block)
        sums = (blocked * vb).sum(dim=reduce_axes,
                                  dtype=torch.int64).to(torch.int32)
        counts = vb.sum(dim=reduce_axes, dtype=torch.int64).to(
            torch.int32).clamp_(min=1)
    # Exact integer round-half-up: round(s/c) = floor((2s + c) / (2c)); the
    # division must floor (not truncate) for negative sums.
    means = torch.div(2 * sums + counts, 2 * counts, rounding_mode="floor")
    return means.to(torch.int32)


def blockmean_decorrelate(q: torch.Tensor, means: torch.Tensor,
                          block: Sequence[int]) -> torch.Tensor:
    """``p = q - upsample(M)`` (HSZx / HSZx-nd)."""
    return q - blocking.upsample_block_means(means, block)


def blockmean_recorrelate(p: torch.Tensor, means: torch.Tensor,
                          block: Sequence[int]) -> torch.Tensor:
    """``q = p + upsample(M)``."""
    return p + blocking.upsample_block_means(means, block)
