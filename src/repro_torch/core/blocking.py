"""n-D data partition / unpartition (paper §IV "Data Partition").

Data is padded (edge mode keeps residual entropy low) to block multiples and
viewed either *spatially* (padded n-D layout — natural for stencils) or
*blocked* ``(grid..., block...)`` (natural for per-block metadata/encoding).
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch


def padded_shape(shape: Sequence[int], block: Sequence[int]) -> tuple[int, ...]:
    return tuple(-(-s // b) * b for s, b in zip(shape, block))


def has_padding(shape: Sequence[int], block: Sequence[int]) -> bool:
    """Does blocking ``shape`` introduce padding?  Decided from shapes."""
    return any(s % b for s, b in zip(shape, block))


def pad_to_blocks(x: torch.Tensor, block: Sequence[int]) -> torch.Tensor:
    """Pad with edge values to block multiples (edge padding keeps |residual| small)."""
    tgt = padded_shape(x.shape, block)
    for axis, (s, t) in enumerate(zip(x.shape, tgt)):
        if t != s:
            idx = torch.arange(t, device=x.device).clamp_(max=s - 1)
            x = x.index_select(axis, idx)
    return x


def crop(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`pad_to_blocks`."""
    return x[tuple(slice(0, s) for s in shape)]


def _blocked_perm(nd: int) -> list[int]:
    return list(range(0, 2 * nd, 2)) + list(range(1, 2 * nd, 2))


def to_blocked(x, block: Sequence[int]):
    """Spatial padded layout -> ``(g0, ..., gk, b0, ..., bk)``.

    Works on torch tensors and numpy arrays alike (the host serializer uses
    the numpy form)."""
    nd = x.ndim
    inter = []
    for s, b in zip(x.shape, block):
        inter += [s // b, b]
    x = x.reshape(inter)
    perm = _blocked_perm(nd)
    return x.permute(perm) if isinstance(x, torch.Tensor) else x.transpose(perm)


def from_blocked(x, block: Sequence[int]):
    """Inverse of :func:`to_blocked` (torch tensors and numpy arrays)."""
    nd = len(block)
    grid = x.shape[:nd]
    perm = []
    for i in range(nd):
        perm += [i, nd + i]
    x = x.permute(perm) if isinstance(x, torch.Tensor) else x.transpose(perm)
    return x.reshape(tuple(g * b for g, b in zip(grid, block)))


def block_grid(shape: Sequence[int], block: Sequence[int]) -> tuple[int, ...]:
    return tuple(p // b for p, b in zip(padded_shape(shape, block), block))


def valid_counts(shape: Sequence[int], block: Sequence[int]) -> np.ndarray:
    """Number of *valid* (non-padding) elements per block, row-major grid order.

    Computed host-side (shapes are static) and attached to the container so
    padding-aware homomorphic statistics stay exact.
    """
    grid = block_grid(shape, block)
    per_axis = []
    for s, b, g in zip(shape, block, grid):
        idx = np.arange(g)
        full = np.minimum((idx + 1) * b, s) - idx * b
        per_axis.append(np.maximum(full, 0))
    counts = per_axis[0]
    for a in per_axis[1:]:
        counts = np.multiply.outer(counts, a)
    return counts.reshape(-1).astype(np.int32)


def valid_mask(shape: Sequence[int], block: Sequence[int]) -> np.ndarray:
    """Boolean spatial mask of valid elements in the padded layout."""
    pshape = padded_shape(shape, block)
    mask = np.ones(pshape, dtype=bool)
    for axis, (s, p) in enumerate(zip(shape, pshape)):
        if p > s:
            idx = [slice(None)] * len(pshape)
            idx[axis] = slice(s, p)
            mask[tuple(idx)] = False
    return mask


def upsample_block_means(means: torch.Tensor, block: Sequence[int]) -> torch.Tensor:
    """Broadcast per-block values back to the spatial padded layout.

    ``means`` has grid shape ``(g0, ..., gk)``; result has shape
    ``(g0*b0, ..., gk*bk)``.  Used by HSZx-family recorrelation and the
    homomorphic border-correction stencils (paper §V-B②).
    """
    x = means
    for axis in range(means.ndim):
        x = torch.repeat_interleave(x, block[axis], dim=axis)
    return x
