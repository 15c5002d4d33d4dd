"""Block-wise placement of one compressed field over a 1-D shard axis.

The paper's compression pipeline partitions every field into fixed-size
blocks before any transform, and a :class:`~repro_torch.core.region.RegionPlan`
already knows exactly which blocks a query's closure touches — so placement
is a pure function of the *layout*, never of the data: a
:class:`BlockPlacement` assigns each block (via its block-row along one
spatial axis) to a shard, and everything else — participating shards of a
region, per-shard payload-byte accounting, the per-shard word stripes the
word-merge programs consume — derives statically from it.

Placement is **striped** (block-row ``r`` belongs to shard ``r % n_shards``)
rather than sliced into contiguous slabs: a localized region then spreads
its covering rows over ``min(rows, n_shards)`` shards instead of landing on
one, which is what bounds the *max* per-shard bytes a region query touches
(the planner's max-cost rule keys on that maximum).  Striping costs nothing
for full-field scans — every shard owns ``1/n`` of the blocks either way.

All arrays here are host-side numpy: placement is static layout math, built
once per ``(layout, n_shards, axis)`` and reused by every query.
"""
from __future__ import annotations

import numpy as np

from ..core import Compressed, Encoded, Scheme, encode
from ..core.region import RegionPlan

Field = Compressed | Encoded


class BlockPlacement:
    """Static block -> shard assignment for one field layout.

    ``axis`` is the spatial axis whose block-rows are striped (axis 0 for
    spatial fields; temporal slab layouts stripe axis 1, keeping the time
    axis whole so summaries stay per-shard mergeable).  1-D (flat) schemes
    have no rows — individual blocks stripe directly.
    """

    def __init__(self, scheme: Scheme, shape: tuple[int, ...],
                 padded_shape: tuple[int, ...], block: tuple[int, ...],
                 n_shards: int, axis: int = 0):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.scheme = Scheme(scheme)
        self.shape = tuple(shape)
        self.padded_shape = tuple(padded_shape)
        self.block = tuple(block)
        self.n_shards = int(n_shards)
        self.grid = tuple(p // b for p, b in zip(padded_shape, block))
        if self.scheme.is_nd:
            if not (0 <= axis < len(shape)):
                raise ValueError(
                    f"shard axis {axis} out of range for rank {len(shape)}")
            self.axis = int(axis)
            self.n_units = self.grid[self.axis]
        else:
            # flat layouts stripe the 1-D block sequence itself
            self.axis = 0
            self.n_units = self.grid[0]
        self._word_owner_cache: dict[int, np.ndarray] = {}

    @classmethod
    def of(cls, field: Field, n_shards: int, axis: int = 0) -> "BlockPlacement":
        return cls(field.scheme, field.shape, field.padded_shape, field.block,
                   n_shards, axis)

    def sig(self) -> tuple:
        """Hashable static signature (routing cache key component)."""
        return (self.scheme, self.shape, self.padded_shape, self.block,
                self.n_shards, self.axis)

    # -- ownership ----------------------------------------------------------
    def unit_of_blocks(self, block_ids: np.ndarray) -> np.ndarray:
        """Stripe unit (block-row along ``axis``) of raveled block ids."""
        bids = np.asarray(block_ids, dtype=np.int64)
        if not self.scheme.is_nd:
            return bids
        stride = int(np.prod(self.grid[self.axis + 1:], dtype=np.int64))
        return (bids // stride) % self.grid[self.axis]

    def owner_of_blocks(self, block_ids: np.ndarray) -> np.ndarray:
        """Owning shard of each raveled block id."""
        return (self.unit_of_blocks(block_ids) % self.n_shards).astype(np.int32)

    def units_of(self, shard: int) -> np.ndarray:
        """Stripe units owned by ``shard`` (ascending)."""
        if not (0 <= shard < self.n_shards):
            raise ValueError(f"shard {shard} out of range [0, {self.n_shards})")
        return np.arange(shard, self.n_units, self.n_shards, dtype=np.int64)

    def participants(self, plan: RegionPlan) -> tuple[int, ...]:
        """Shards owning at least one of the plan's covering blocks."""
        owners = self.owner_of_blocks(plan.block_ids)
        return tuple(int(s) for s in np.unique(owners))

    def home(self, plan: RegionPlan | None) -> int:
        """Home shard of one cache cell: the majority owner of its covering
        blocks (full field: shard 0 — every shard owns ``~1/n`` either way).
        Materializations live in the home shard's budget, so eviction
        pressure is per-shard, never global."""
        if plan is None:
            return 0
        owners = self.owner_of_blocks(plan.block_ids)
        return int(np.bincount(owners, minlength=self.n_shards).argmax())

    # -- value / word geometry ----------------------------------------------
    def _value_owner(self, values: np.ndarray) -> np.ndarray:
        """Owning shard of flat *padded* value indices."""
        v = np.asarray(values, dtype=np.int64)
        if not self.scheme.is_nd:
            return ((v // self.block[0]) % self.n_shards).astype(np.int32)
        stride = int(np.prod(self.padded_shape[self.axis + 1:], dtype=np.int64))
        coord = (v // stride) % self.padded_shape[self.axis]
        return ((coord // self.block[self.axis]) % self.n_shards).astype(np.int32)

    def word_owner(self, bits: int) -> np.ndarray:
        """Owning shard of every payload word (by the word's first value).

        A word straddling two stripes belongs wholly to the first value's
        owner — words are the indivisible transfer unit, so each is placed
        exactly once and the scatter/psum merge never splits bits.
        """
        owners = self._word_owner_cache.get(bits)
        if owners is not None:
            return owners
        n_values = int(np.prod(self.padded_shape, dtype=np.int64))
        n_words = encode.words_for(n_values, bits)
        first_value = np.minimum(
            (np.arange(n_words, dtype=np.int64) * 32) // max(bits, 1),
            max(n_values - 1, 0))
        owners = self._value_owner(first_value)
        self._word_owner_cache[bits] = owners
        return owners

    def shard_word_index(self, bits: int) -> list[np.ndarray]:
        """Per-shard ascending global word indices (the physical payload
        stripe each shard holds)."""
        owners = self.word_owner(bits)
        return [np.nonzero(owners == s)[0] for s in range(self.n_shards)]

    # -- accounting ---------------------------------------------------------
    def payload_bytes(self, plan: RegionPlan, bits: int) -> dict:
        """Payload bytes a region decode touches, per shard and single-device.

        The single-device path gathers every word of the plan's
        :meth:`~repro_torch.core.region.RegionPlan.payload_gather`; the sharded
        path reads each gathered word from exactly one owning shard's local
        stripe, so the per-shard figure is that shard's share of the gather.
        """
        gi = plan.payload_gather(bits)
        owners = self.word_owner(bits)[gi.word_idx] if gi.n_words else \
            np.zeros((0,), np.int32)
        per_shard = np.bincount(owners, minlength=self.n_shards) * 4
        return {
            "single_bytes": int(gi.n_words) * 4,
            "per_shard_bytes": [int(b) for b in per_shard],
            "max_shard_bytes": int(per_shard.max()) if self.n_shards else 0,
            "participants": [int(s) for s in np.nonzero(per_shard)[0]],
        }

    def closure_fractions(self, plan: RegionPlan) -> np.ndarray:
        """Per-shard fraction of the *field* each shard decodes for the
        plan's closure (planner input: a stage's measured full-field cost
        scales by a participating shard's share, and the sharded cost of
        the stage is the **max** over shards, not the sum — shards decode
        their blocks concurrently)."""
        owners = self.owner_of_blocks(plan.block_ids)
        counts = np.bincount(owners, minlength=self.n_shards).astype(np.float64)
        block_elems = float(np.prod(self.block, dtype=np.int64))
        total = float(np.prod(self.padded_shape, dtype=np.int64))
        return counts * block_elems / total

    def max_fraction(self, plan: RegionPlan | None = None) -> float:
        """Max per-shard share of the field's decode work — the planner's
        sharded cost rule scales a stage's measured full-field cost by this
        (shards decode concurrently, so the critical path is the busiest
        shard, never the sum).  ``plan=None`` is the full-field figure."""
        if plan is not None:
            return float(self.closure_fractions(plan).max())
        units = np.arange(self.n_units, dtype=np.int64) % self.n_shards
        counts = np.bincount(units, minlength=self.n_shards)
        return float(counts.max()) / max(self.n_units, 1)
