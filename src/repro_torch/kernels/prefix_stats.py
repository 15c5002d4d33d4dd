"""Paper Algorithm 4, ``(Σq, Σq²)`` of ``q = unlorenzo(p)`` without writing
``q``: the Hopper kernels and their plain version.

Counterpart of ``repro/kernels/prefix_stats.py:prefix_stats2d``.  The TPU
kernel carries the previous row of ``q`` across a sequential grid; Hopper
blocks run in no order, so nothing is carried.  Instead (``csrc/lorenzo_band.cu``):

1. the Lorenzo edge pass (:func:`fused.lorenzo_edges`, plane input) writes
   the row edge (Σp left of each 32 × 128 tile, per row) and the column edge
   (Σp above each tile, per column);
2. one small torch cumsum along columns of the column edge gives the row of
   ``q`` just above each tile;
3. the stats pass rebuilds ``q`` per tile in shared memory (modular int32),
   sums ``q`` and ``q²`` in f64, and writes one pair per tile; a second
   launch of one block sums the pairs in a fixed order and rounds to f32.

No float atomics, so a launch gives the same bits run after run.  The f64
sums are exact integers while ``|q| < 2^26`` and the totals stay below
``2^53``, so the result is the exact ``(Σq, Σq²)`` rounded once to f32; the
reference's f32 sums round at every step (its tests allow rtol 1e-5).

Unlike the reference, which refuses row counts that are not a multiple of
its 64-row TPU band, every 2-D shape is accepted.
"""
from __future__ import annotations

import torch

from . import build, fused, ops


def prefix_stats2d_plain(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version, the reference oracle: ``q`` materialized as int32, then
    f32 sums of ``q`` and ``q²``."""
    q = torch.cumsum(torch.cumsum(p, dim=0, dtype=torch.int32), dim=1,
                     dtype=torch.int32)
    qf = q.to(torch.float32)
    return torch.sum(qf), torch.sum(qf * qf)


def tile_edges(rowedge: torch.Tensor, coledge: torch.Tensor):
    """(row edge, row of q above each tile) from the edge pass's row edge
    ``(n0, n_ct)`` and column edge ``(n_rt, n1)``."""
    return rowedge, torch.cumsum(coledge, dim=1, dtype=torch.int32)


def prefix_stats_tiles(p: torch.Tensor, rowedge: torch.Tensor,
                       top: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stats pass (kernel): per-tile f64 pairs, then the fixed-order sum."""
    n0, n1 = p.shape
    th, tw = fused.lorenzo_tile()
    n_tiles = -(-n0 // th) * -(-n1 // tw)
    partials = torch.empty((n_tiles, 2), dtype=torch.float64, device=p.device)
    out = torch.empty((2,), dtype=torch.float32, device=p.device)
    build.call("hsz_prefix_stats", p.data_ptr(), n0, n1, rowedge.data_ptr(),
               top.data_ptr(), partials.data_ptr(), out.data_ptr(),
               ops.stream_ptr())
    ops.count("prefix_stats2d.stats")
    return out[0], out[1]


def prefix_stats2d(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(Σq, Σq²)`` as two f32 scalars for ``q = cumsum(cumsum(p, 0), 1)``
    of a 2-D int32 residual plane."""
    if not ops.on_card(p):
        return prefix_stats2d_plain(p)
    ops.check(p, "residuals", torch.int32)
    if p.ndim != 2 or p.numel() == 0:
        raise ValueError(f"prefix_stats2d takes a non-empty 2-D plane, got "
                         f"{tuple(p.shape)}")
    edges = fused.lorenzo_edges(p, tuple(p.shape), 0, from_payload=False,
                                site="prefix_stats2d")
    return prefix_stats_tiles(p, *tile_edges(*edges))
