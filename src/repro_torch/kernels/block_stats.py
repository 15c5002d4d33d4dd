"""Per-block metadata reduction: the Hopper kernel and its plain version.

Counterpart of ``repro/kernels/block_stats.py:block_stats``: for each row of
an ``(n_blocks, S)`` int32 matrix, the rounded integer mean
``floor((2s + S) / (2S))`` (``s`` the modular int32 sum; the division floors,
as ``decorrelate.block_means`` does) and the unsigned max of the zigzag
values.  The max is returned as the int32 bit pattern of its uint32 value,
the port's convention for 32-bit words (``core/encode.py``).

Unlike the reference, which refuses row counts that are not a multiple of
its 256-row TPU grid step, any ``n_blocks`` is accepted: Ocean's 33 750
blocks of 16 × 16 included.
"""
from __future__ import annotations

import torch

from . import build, ops

_WORD_MASK = 0xFFFFFFFF


def block_stats_plain(q_blocked: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: int32 sums and floor division; the zigzag max compared
    as unsigned (in int64), returned as an int32 bit pattern."""
    cnt = q_blocked.shape[1]
    s = q_blocked.sum(dim=1, dtype=torch.int64).to(torch.int32)
    means = torch.div(2 * s + cnt, 2 * cnt, rounding_mode="floor")
    z = ((q_blocked << 1) ^ (q_blocked >> 31)).to(torch.int64) & _WORD_MASK
    maxu = z.amax(dim=1)
    maxu = torch.where(maxu >= 2 ** 31, maxu - 2 ** 32, maxu).to(torch.int32)
    return means.to(torch.int32), maxu


def block_stats(q_blocked: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block (integer mean, zigzag max) of ``(n_blocks, S)`` int32 rows."""
    if q_blocked.ndim != 2 or q_blocked.shape[1] == 0:
        raise ValueError(f"block_stats takes (n_blocks, S >= 1) rows, got "
                         f"{tuple(q_blocked.shape)}")
    if not ops.on_card(q_blocked):
        return block_stats_plain(q_blocked)
    ops.check(q_blocked, "q_blocked", torch.int32)
    nb, s = q_blocked.shape
    means = torch.empty((nb,), dtype=torch.int32, device=q_blocked.device)
    maxu = torch.empty((nb,), dtype=torch.int32, device=q_blocked.device)
    if nb:
        build.call("hsz_block_stats", q_blocked.data_ptr(), nb, s,
                   means.data_ptr(), maxu.data_ptr(), ops.stream_ptr())
        ops.count("block_stats")
    return means, maxu
