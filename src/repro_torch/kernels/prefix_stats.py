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

:func:`prefix_stats_batch` takes a ``(B, n0, n1)`` batch of planes (the
leaves of a ``batch_stack`` view) in one launch of each kernel and gives
``(B, 2)``: the stats pass walks every field's tiles, each block keeps one
pair per field, and the reduction runs a block per field.  The reference's
sequential carry breaks under ``jax.vmap``; these kernels carry nothing
between tiles.  As the sums are exact, a field's pair is the same bits
alone or in any batch.  The serving rules of Lorenzo stage-② ``mean`` and
``std`` read it (``core.oplib.StageContext.lorenzo_moments``).
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


def prefix_stats_batch_plain(p: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`prefix_stats_batch`: each plane's
    :func:`prefix_stats2d_plain`, stacked (``(B, 2)``, or ``(2,)`` for one
    plane)."""
    if p.ndim == 2:
        return torch.stack(prefix_stats2d_plain(p))
    return torch.stack([torch.stack(prefix_stats2d_plain(x)) for x in p])


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
    modular; of each field of a ``(B, n_rt, n1)`` batch."""
    lead = tuple(coledge.shape[:-2])
    n_rt, n1 = coledge.shape[-2:]
    n_cb = -(-n1 // cols)
    z = torch.zeros(lead + (n_rt, n_cb * cols), dtype=torch.int64,
                    device=coledge.device)
    z[..., :n1] = coledge
    return z.reshape(lead + (n_rt, n_cb, cols)).sum(-1).to(torch.int32)


def stats_edges(p: torch.Tensor, site: str = "prefix_stats2d"):
    """Edge pass of the stats (kernels): the row edge, the column edge and
    the corner sums of :func:`corner_sums_plain` at :func:`corner_cols`
    (of every plane of a ``(B, n0, n1)`` batch, one launch of each
    kernel)."""
    n0, n1 = p.shape[-2:]
    th, _ = fused.lorenzo_tile()
    corners = torch.empty(tuple(p.shape[:-2]) + (-(-n0 // th),
                                                 -(-n1 // corner_cols())),
                          dtype=torch.int32, device=p.device)
    rowedge, coledge = fused.lorenzo_edges(p, (n0, n1), 0, from_payload=False,
                                           site=site, corners=corners)
    return rowedge, coledge, corners


@functools.cache
def stats_grid(n0: int, n1: int, batch: int) -> int:
    """Blocks of the stats pass over ``batch`` (n0, n1) planes (its
    partials hold one pair per field and block), read from the library
    once per shape."""
    grid = ctypes.c_int()
    build.call("hsz_prefix_stats_grid", n0, n1, batch, ctypes.addressof(grid))
    return grid.value


def prefix_stats_tiles(p: torch.Tensor, rowedge: torch.Tensor,
                       coledge: torch.Tensor, corners: torch.Tensor, *,
                       site: str = "prefix_stats2d") -> torch.Tensor:
    """Stats pass (kernels): per-block f64 pairs of each field, then the
    fixed-order sums; ``(2,)`` f32, or ``(B, 2)`` for a batch."""
    lead = tuple(p.shape[:-2])
    n0, n1 = p.shape[-2:]
    batch = lead[0] if lead else 1
    partials = torch.empty((batch, stats_grid(n0, n1, batch), 2),
                           dtype=torch.float64, device=p.device)
    out = torch.empty(lead + (2,), dtype=torch.float32, device=p.device)
    build.call("hsz_prefix_stats", p.data_ptr(), n0, n1, batch,
               rowedge.data_ptr(), coledge.data_ptr(), corners.data_ptr(),
               partials.data_ptr(), partials.numel() // 2, out.data_ptr(),
               ops.stream_ptr())
    ops.count(f"{site}.stats")
    return out


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
    out = prefix_stats_tiles(p, *stats_edges(p))
    return out[0], out[1]


def prefix_stats_batch(p: torch.Tensor) -> torch.Tensor:
    """``(Σq, Σq²)`` f32 of every plane of a ``(B, n0, n1)`` int32 batch,
    ``(B, 2)`` (``(2,)`` for one ``(n0, n1)`` plane), each the exact sums
    rounded once: the same bits as the plane alone.  Counted under the
    ``lorenzo_moments`` sites, the serving rules' own."""
    if not ops.on_card(p):
        return prefix_stats_batch_plain(p)
    ops.check(p, "residuals", torch.int32)
    if p.ndim not in (2, 3) or p.numel() == 0:
        raise ValueError(f"prefix_stats_batch takes a non-empty 2-D plane or "
                         f"a batch of them, got {tuple(p.shape)}")
    site = "lorenzo_moments"
    return prefix_stats_tiles(p, *stats_edges(p, site), site=site)
