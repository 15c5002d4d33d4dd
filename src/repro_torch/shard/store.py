"""Sharded field store: block-wise placement over the analytics mesh.

A :class:`ShardedFieldStore` holds one :class:`~repro_torch.stream
.StreamFieldStore` **per shard** — each with its own byte budget, LRU
order, and stats — over a single shared field registry.  Every cache cell
(a materialized stage or a temporal summary) lives in exactly one shard's
store, chosen by the cell's *home shard* (the majority owner of its
region's covering blocks, :meth:`~repro_torch.shard.placement
.BlockPlacement.home`), so eviction pressure is per-shard: a hot region on
shard 3 never evicts shard 5's materializations.

Serving stays bit-identical to the single-device :class:`~repro_torch.store
.FieldStore` by construction, not by tolerance:

* a cache miss materializes the cell's *integer* intermediate (stage-②
  ``sub`` / stage-③ ``q_spatial``) through the word-merge program
  (:meth:`~repro_torch.shard.exec.ShardPrograms.materialize`) — integer
  reconstruction is exact, so the intermediate equals the single-device
  ``repro_torch.store.materialize`` bit for bit;
* queries then seed the analytics engine's **standard** programs with that
  intermediate, inheriting the store layer's seeded == unseeded
  bit-identity — the float postludes are the same code on the same
  integers;
* temporal summaries reduce per block-row band and merge by an int32 sum /
  min / max over the shard axis (:meth:`~repro_torch.shard.exec
  .ShardPrograms.merge_band_summaries`) — associative, exact.

``retain_payload=False`` additionally drops the registered container's
payload (only the per-shard word stripes stay resident), unlocking fields
larger than one device's memory; the default keeps it, so op sets the
planner declines to seed (or cells over every budget) can still fall back to
the ordinary unseeded path.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence
from functools import reduce

import numpy as np

from ..core import Encoded, Stage, layout_key, oplib
from ..core import region as region_mod
from ..core.oplib import TemporalSummary
from ..store import MATERIALIZABLE, FieldStore, StoreStats
from ..store.materialized import (MaterializedStage, materialized_nbytes,
                                  storage_stage)
from ..stream import StreamFieldStore, TemporalField
from ..stream.store import TEMPORAL_TAG

from .exec import ShardPrograms, spatial_bands
from .placement import BlockPlacement


class ShardedFieldStore:
    """Block-sharded analytics store over a ``("shard",)`` mesh.

    Duck-types the query/serve store surface (``get`` / ``seed`` /
    ``cached_stages`` / ``is_resident`` / ``stats`` / ``temporal_summary``
    / ``append`` / ...), so ``repro_torch.analytics.query`` and the serve
    frontend use it unchanged.  ``cache_bytes_per_shard`` budgets each
    shard's LRU independently; ``mesh`` comes from
    :func:`repro_torch.launch.mesh.make_analytics_mesh`.
    """

    def __init__(self, mesh, cache_bytes_per_shard: int = 256 << 20, *,
                 engine=None, cost_model=None, retain_payload: bool = True,
                 shard_axis: int = 0):
        self.mesh = mesh
        self.progs = ShardPrograms(mesh)
        self.n_shards = self.progs.n_shards
        self.cost_model = cost_model
        self.retain_payload = bool(retain_payload)
        self.shard_axis = int(shard_axis)
        self._fields: dict = {}
        self._shards = [StreamFieldStore(cache_bytes_per_shard,
                                         engine=engine, cost_model=cost_model)
                        for _ in range(self.n_shards)]
        for s in self._shards:
            s._fields = self._fields  # one registry, n_shards cache budgets
        self._placements: dict[str, BlockPlacement] = {}
        self._stripes: dict[str, tuple] = {}
        #: monotone counters of streaming refresh work (parent-level: the
        #: children only account bytes/LRU, never compute)
        self.incremental_merges = 0
        self.summary_rebuilds = 0

    @property
    def engine(self):
        return self._shards[0].engine

    # -- aggregated accounting ----------------------------------------------
    @property
    def stats(self) -> StoreStats:
        """Aggregate accounting across shards (fresh snapshot; per-shard
        figures live on ``shard_stats``)."""
        agg = StoreStats()
        for c in self._shards:
            agg.hits += c.stats.hits
            agg.misses += c.stats.misses
            agg.evictions += c.stats.evictions
            agg.rejected += c.stats.rejected
        return agg

    @property
    def shard_stats(self) -> tuple[StoreStats, ...]:
        return tuple(c.stats for c in self._shards)

    @property
    def cache_bytes_in_use(self) -> int:
        return sum(c.cache_bytes_in_use for c in self._shards)

    @property
    def cache_entries(self) -> int:
        return sum(c.cache_entries for c in self._shards)

    # -- field registry -----------------------------------------------------
    def _claim_id(self, field_id: str, replace: bool) -> None:
        """Free ``field_id`` for a new registration (``replace=True``
        drops the old one's cells) or refuse it."""
        if field_id in self._fields:
            if not replace:
                raise ValueError(
                    f"field id {field_id!r} already registered "
                    "(pass replace=True to overwrite)")
            self.invalidate(field_id)

    def put(self, field_id: str, field, *, replace: bool = False) -> str:
        """Register an :class:`Encoded` field, striping its payload words
        over the shard axis (placement is static layout math — see
        :class:`BlockPlacement`)."""
        if not isinstance(field_id, str) or not field_id:
            raise ValueError(
                f"field id must be a non-empty string, got {field_id!r}")
        if not isinstance(field, Encoded):
            raise TypeError(
                "the sharded store places packed payload words; encode the "
                f"field first (Encoded), got {type(field).__name__}")
        self._claim_id(field_id, replace)
        placement = BlockPlacement.of(field, self.n_shards,
                                      axis=self.shard_axis)
        self._stripes[field_id] = self.progs.shard_payload(field, placement)
        self._placements[field_id] = placement
        if not self.retain_payload:
            field = dataclasses.replace(
                field, payload=field.payload.new_zeros((0,)))
        self._fields[field_id] = field
        return field_id

    def put_temporal(self, field_id: str, tf: TemporalField, *,
                     replace: bool = False) -> str:
        """Register an append-only temporal field; its summaries shard by
        block-rows of the first *spatial* axis (slab axis 1 — the time axis
        stays whole, so per-shard partial summaries merge exactly)."""
        if not isinstance(field_id, str) or not field_id:
            raise ValueError(
                f"field id must be a non-empty string, got {field_id!r}")
        if not isinstance(tf, TemporalField):
            raise TypeError(
                f"expected a TemporalField, got {type(tf).__name__}")
        self._claim_id(field_id, replace)
        self._fields[field_id] = tf
        return field_id

    def get(self, field_id: str):
        try:
            return self._fields[field_id]
        except KeyError:
            raise KeyError(
                f"unknown field id {field_id!r}; registered ids: "
                f"{sorted(self._fields) or '(none)'}") from None

    def remove(self, field_id: str) -> None:
        self.get(field_id)
        self.invalidate(field_id)
        del self._fields[field_id]
        self._placements.pop(field_id, None)
        self._stripes.pop(field_id, None)

    def invalidate(self, field_id: str) -> int:
        """Drop every shard's materializations of ``field_id``."""
        return sum(c.invalidate(field_id) for c in self._shards)

    def __contains__(self, field_id: str) -> bool:
        return field_id in self._fields

    def __len__(self) -> int:
        return len(self._fields)

    def ids(self) -> tuple[str, ...]:
        return tuple(self._fields)

    def is_temporal(self, field_id: str) -> bool:
        return isinstance(self.get(field_id), TemporalField)

    def _temporal(self, field_id: str) -> TemporalField:
        tf = self.get(field_id)
        if not isinstance(tf, TemporalField):
            raise TypeError(
                f"field id {field_id!r} is not a temporal field; append() "
                "and temporal ops need a TemporalField (see put_temporal)")
        return tf

    # -- placement ----------------------------------------------------------
    def placement_of(self, field_id: str) -> BlockPlacement | None:
        """The id's placement (spatial fields; the planner's max-cost rule
        consumes this).  ``None`` for temporal ids — their cells are
        summaries, not stage decodes."""
        return self._placements.get(field_id)

    def _temporal_placement(self, field_id: str,
                            tf: TemporalField) -> BlockPlacement:
        pl = self._placements.get(field_id)
        if pl is None:
            if not tf.slabs:
                raise ValueError(
                    f"temporal field {field_id!r} has no appended slabs")
            pl = BlockPlacement.of(tf.slabs[0], self.n_shards, axis=1)
            self._placements[field_id] = pl
        return pl

    def shard_of(self, field_id: str, stage: Stage | None = None, *,
                 region=None, closure="cover") -> int:
        """Home shard of one cache cell (tests / ops introspection)."""
        field = self.get(field_id)
        if isinstance(field, TemporalField):
            norm = (region_mod.normalize_region(region, field.shape)
                    if region is not None else None)
            return self._temporal_home(field_id, field, norm)
        norm, cl = self._canonical(field, Stage(stage), region, closure)
        return self._home(field, norm, cl)

    def payload_accounting(self, field_id: str, ops, stage: Stage, *,
                           region, axis: int = 0) -> dict:
        """Per-shard payload bytes one region query touches (see
        :meth:`BlockPlacement.payload_bytes`)."""
        field = self.get(field_id)
        names = oplib.canonical_ops(ops)
        cl = oplib.set_closure(names, field.scheme, Stage(stage), axis)
        norm, cl = self._canonical(field, Stage(stage), region, cl)
        plan = region_mod.plan_region(field, norm, cl)
        return self._placements[field_id].payload_bytes(plan, field.bits)

    # -- cell routing ---------------------------------------------------------
    def _canonical(self, field, stage: Stage, region, closure):
        norm = (region_mod.normalize_region(region, field.shape)
                if region is not None else None)
        return norm, region_mod.canonical_closure(field.scheme, closure, norm)

    def _home(self, field, norm, closure) -> int:
        placement = BlockPlacement.of(field, self.n_shards,
                                      axis=self.shard_axis)
        if norm is None:
            return placement.home(None)
        return placement.home(region_mod.plan_region(field, norm, closure))

    def _cell(self, field_id: str, stage: Stage, region, closure):
        field = self.get(field_id)
        norm, cl = self._canonical(field, stage, region, closure)
        key = FieldStore._key(field_id, stage, norm, cl)
        return field, norm, cl, key, self._shards[self._home(field, norm, cl)]

    # -- materialization cache ------------------------------------------------
    def _materialize(self, field_id: str, field: Encoded, stage: Stage,
                     norm, closure) -> MaterializedStage:
        st = storage_stage(stage)
        inter = self.progs.materialize(
            field, st, region=norm, closure=closure,
            placement=self._placements[field_id],
            stripes=self._stripes[field_id])
        return MaterializedStage(
            sub=inter if st == Stage.P else None,
            q_spatial=None if st == Stage.P else inter,
            stage=st, closure=closure, region=norm)

    def lookup(self, field_id: str, stage: Stage, *, region=None,
               closure="cover") -> MaterializedStage | None:
        _, _, _, key, child = self._cell(field_id, Stage(stage), region,
                                         closure)
        m = child._peek_hit(key)
        if m is None:
            child.stats.misses += 1
        return m

    def ensure(self, field_id: str, stage: Stage, *, region=None,
               closure="cover") -> MaterializedStage:
        m = self.lookup(field_id, stage, region=region, closure=closure)
        if m is not None:
            return m
        field, norm, cl, key, child = self._cell(field_id, Stage(stage),
                                                 region, closure)
        m = self._materialize(field_id, field, Stage(stage), norm, cl)
        child._insert(key, m)
        return m

    def seed(self, field_id: str, stage: Stage, *, region=None,
             closure="cover") -> MaterializedStage | None:
        """Single-device :meth:`FieldStore.seed` semantics, per home shard.

        A cell larger than its home shard's whole budget is declined
        (``None`` — the engine falls back to the retained payload) when the
        payload is retained; in capacity mode (``retain_payload=False``)
        there is no fallback payload, so the cell is computed through the
        sharded program anyway and returned *without* being retained — the
        rejection is still counted on the home shard.
        """
        field, norm, cl, key, child = self._cell(field_id, Stage(stage),
                                                 region, closure)
        m = child._peek_hit(key)
        if m is not None:
            return m
        if materialized_nbytes(field, stage, region=region,
                               closure=cl) > child.cache_bytes:
            child.stats.rejected += 1
            if self.retain_payload:
                return None
            return self._materialize(field_id, field, Stage(stage), norm, cl)
        child.stats.misses += 1
        m = self._materialize(field_id, field, Stage(stage), norm, cl)
        child._insert(key, m)
        return m

    # -- planner input --------------------------------------------------------
    def is_resident(self, field_id: str, stage: Stage, *, region=None,
                    closure="cover") -> bool:
        _, _, _, key, child = self._cell(field_id, Stage(stage), region,
                                         closure)
        return key in child._cache

    def cached_stages(self, field_ids, ops, *, region=None,
                      axis: int = 0) -> frozenset[Stage]:
        """:meth:`FieldStore.cached_stages`, with each cell checked in its
        home shard's cache (pure peek)."""
        names = oplib.canonical_ops(ops)
        vector = oplib.is_vector_ops(names)
        fids = list(field_ids) if vector else [field_ids]
        if isinstance(field_ids, str) and vector:
            raise ValueError("vector op sets need one field id per component")
        fields = [self.get(f) for f in fids]
        out = set()
        for stage in MATERIALIZABLE:
            if vector:
                closures = oplib.component_closures(
                    names, [f.scheme for f in fields], stage)
            else:
                closures = (oplib.set_closure(names, fields[0].scheme, stage,
                                              axis),)
            resident = True
            for fid, field, cl in zip(fids, fields, closures):
                norm, cl = self._canonical(field, stage, region, cl)
                key = FieldStore._key(fid, stage, norm, cl)
                if key not in self._shards[self._home(field, norm, cl)]._cache:
                    resident = False
                    break
            if resident:
                out.add(stage)
        return frozenset(out)

    # -- temporal serving ------------------------------------------------------
    def _temporal_home(self, field_id: str, tf: TemporalField, norm) -> int:
        pl = self._temporal_placement(field_id, tf)
        owners = [o for o, _, _, _ in spatial_bands(tf.slabs[0], pl, norm)]
        return int(np.bincount(np.asarray(owners, dtype=np.int64),
                               minlength=self.n_shards).argmax())

    def _summary_stage(self, tf: TemporalField, region=None) -> Stage:
        return self._shards[0]._summary_stage(tf, region)

    def _banded_summaries(self, field_id: str, tf: TemporalField,
                          slabs: Sequence, stage: Stage, norm
                          ) -> list[TemporalSummary]:
        """Per-slab full-window summaries via per-band partials + the
        shard-axis merge — bit-identical to ``engine.summarize`` over the
        whole window (int32 leaves, positionwise)."""
        pl = self._temporal_placement(field_id, tf)
        engine = self.engine
        spatial = slabs[0].shape[1:]
        win = norm if norm is not None else tuple((0, s) for s in spatial)
        win_rows = win[0][1] - win[0][0]
        rest = tuple(hi - lo for lo, hi in win[1:])
        bands = spatial_bands(slabs[0], pl, norm)
        # one batched summarize per (band, slab layout), like the
        # single-device path
        groups: dict[tuple, list[int]] = {}
        for i, slab in enumerate(slabs):
            groups.setdefault(layout_key(slab), []).append(i)
        per_slab: list[list] = [[] for _ in slabs]
        for owner, row0, _, breg in bands:
            for indices in groups.values():
                stacked = engine.summarize([slabs[i] for i in indices], stage,
                                           region=breg)
                for j, i in enumerate(indices):
                    part = oplib.map_summaries(lambda x, _j=j: x[_j], stacked)
                    per_slab[i].append((owner, row0, part))
        return [self.progs.merge_band_summaries(parts, win_rows, rest)
                for parts in per_slab]

    def temporal_summary(self, field_id: str, *, region=None,
                         stage=None) -> TemporalSummary:
        """Merged summary over every appended slab — band partials reduced
        per shard, merged over the shard axis, then folded in temporal order
        (the fold is the same ``engine.merge_summaries`` the single-device
        store uses, so the result is bit-identical to it)."""
        tf = self._temporal(field_id)
        if not tf.slabs:
            raise ValueError(
                f"temporal field {field_id!r} has no appended slabs")
        norm = (region_mod.normalize_region(region, tf.shape)
                if region is not None else None)
        key = (field_id, TEMPORAL_TAG, norm)
        child = self._shards[self._temporal_home(field_id, tf, norm)]
        m = child._peek_hit(key)
        if m is not None:
            return m
        child.stats.misses += 1
        if stage is None:
            stage = self._summary_stage(tf, norm)
        parts = self._banded_summaries(field_id, tf, tf.slabs, Stage(stage),
                                       norm)
        merged = reduce(self.engine.merge_summaries, parts)
        self.summary_rebuilds += 1
        child._insert(key, merged)
        return merged

    # -- streaming ingest ------------------------------------------------------
    def append(self, field_id: str, data) -> int:
        """Ingest one slab; refresh every *resident* summary cell of the id
        in whichever shard holds it — only the owning shards' bands of the
        new slab are reconstructed, and each refresh is a replace-in-place
        merge on that shard's cache (other shards' cells are untouched)."""
        from ..analytics.planner import plan_refresh

        tf = self._temporal(field_id)
        idx = tf.append(data)
        slab = tf.slabs[idx]
        resident = [(c, k) for c in self._shards for k in list(c._cache)
                    if k[0] == field_id and k[1] == TEMPORAL_TAG]
        plan = plan_refresh(tf.scheme, self._summary_stage(tf),
                            tf.n_slabs, self.cost_model,
                            summary_resident=bool(resident))
        if plan.mode != "incremental":
            return idx
        for child, key in resident:
            old = child._cache.get(key)
            if old is None:
                continue  # evicted by an earlier refresh in this very loop
            norm = key[2]
            part = self._banded_summaries(
                field_id, tf, [slab], self._summary_stage(tf, norm), norm)[0]
            merged = self.engine.merge_summaries(old, part)
            child._insert(key, merged)
            self.incremental_merges += 1
        return idx
