"""Paper Algorithm 4, ``(Σq, Σq²)`` of ``q = unlorenzo(p)`` without writing
``q``: the Hopper kernels and their plain version.

Counterpart of ``repro/kernels/prefix_stats.py:prefix_stats2d``.  The TPU
kernel carries the previous row of ``q`` across a sequential grid; Hopper
blocks run in no order, so nothing is carried.  Instead four kernels of
``csrc/lorenzo_band.cu`` run, and no torch op sits between them:

1. the Lorenzo edge pass (:func:`fused.lorenzo_edges`, plane input) writes
   the row edge (Σp left of each 32 × 128 tile, per row) and the column edge
   (Σp above each tile, per column);
2. its prefix kernel, in the mode that also writes the corner sums: per
   tile row, the column edge summed over each :func:`corner_cols` columns;
3. the stats pass rebuilds ``q`` per tile on a register tile (modular
   int32): the row of ``q`` above the tile is the tile's corner
   (``Σ p[i < i0, j < j0]``, the corner sums left of it) plus a scan of its
   column edge; a persistent grid carries each thread's f64 sums of ``q``
   and ``q²`` over its block's tiles and writes one pair per block;
4. one block sums the pairs in a fixed order and rounds to f32.

No float atomics, so a launch gives the same bits run after run (on one
card: the grid is as many blocks as the card holds at once).  The f64
sums are exact integers while ``|q| < 2^26`` and the totals stay below
``2^53``, so the result is the exact ``(Σq, Σq²)`` rounded once to f32; the
reference's f32 sums round at every step (its tests allow rtol 1e-5).

Unlike the reference, which refuses row counts that are not a multiple of
its 64-row TPU band, every 2-D shape is accepted.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, fused, ops


def prefix_stats2d_plain(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version, the reference oracle: ``q`` materialized as int32, then
    f32 sums of ``q`` and ``q²``."""
    q = torch.cumsum(torch.cumsum(p, dim=0, dtype=torch.int32), dim=1,
                     dtype=torch.int32)
    qf = q.to(torch.float32)
    return torch.sum(qf), torch.sum(qf * qf)


@functools.cache
def corner_cols() -> int:
    """Columns per corner sum, the edge prefix kernel's column block, read
    from the library once."""
    cols = ctypes.c_int()
    build.call("hsz_corner_cols", ctypes.addressof(cols))
    return cols.value


def corner_sums_plain(coledge: torch.Tensor, cols: int) -> torch.Tensor:
    """Plain version of the corner sums: the column edge ``(n_rt, n1)``
    summed over each ``cols`` columns, ``(n_rt, ceil(n1/cols))`` int32,
    modular."""
    n_rt, n1 = coledge.shape
    n_cb = -(-n1 // cols)
    z = torch.zeros((n_rt, n_cb * cols), dtype=torch.int64,
                    device=coledge.device)
    z[:, :n1] = coledge
    return z.reshape(n_rt, n_cb, cols).sum(2).to(torch.int32)


def stats_edges(p: torch.Tensor):
    """Edge pass of the stats (kernels): the row edge, the column edge and
    the corner sums of :func:`corner_sums_plain` at :func:`corner_cols`."""
    n0, n1 = p.shape
    th, _ = fused.lorenzo_tile()
    corners = torch.empty((-(-n0 // th), -(-n1 // corner_cols())),
                          dtype=torch.int32, device=p.device)
    rowedge, coledge = fused.lorenzo_edges(p, (n0, n1), 0, from_payload=False,
                                           site="prefix_stats2d",
                                           corners=corners)
    return rowedge, coledge, corners


def prefix_stats_tiles(p: torch.Tensor, rowedge: torch.Tensor,
                       coledge: torch.Tensor, corners: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stats pass (kernel): per-block f64 pairs, then the fixed-order sum."""
    n0, n1 = p.shape
    th, tw = fused.lorenzo_tile()
    n_tiles = -(-n0 // th) * -(-n1 // tw)
    partials = torch.empty((n_tiles, 2), dtype=torch.float64, device=p.device)
    out = torch.empty((2,), dtype=torch.float32, device=p.device)
    build.call("hsz_prefix_stats", p.data_ptr(), n0, n1, rowedge.data_ptr(),
               coledge.data_ptr(), corners.data_ptr(), partials.data_ptr(),
               out.data_ptr(), ops.stream_ptr())
    ops.count("prefix_stats2d.stats")
    return out[0], out[1]


def stats_launch_config() -> tuple[int, int, int]:
    """(shared memory in bytes, registers per thread, resident blocks per SM)
    of the stats pass on planes up to 4224 columns, read from the
    library."""
    smem, regs, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    build.call("hsz_prefix_stats_info", ctypes.addressof(smem),
               ctypes.addressof(regs), ctypes.addressof(per_sm))
    return smem.value, regs.value, per_sm.value


def prefix_stats2d(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(Σq, Σq²)`` as two f32 scalars for ``q = cumsum(cumsum(p, 0), 1)``
    of a 2-D int32 residual plane."""
    if not ops.on_card(p):
        return prefix_stats2d_plain(p)
    ops.check(p, "residuals", torch.int32)
    if p.ndim != 2 or p.numel() == 0:
        raise ValueError(f"prefix_stats2d takes a non-empty 2-D plane, got "
                         f"{tuple(p.shape)}")
    return prefix_stats_tiles(p, *stats_edges(p))
