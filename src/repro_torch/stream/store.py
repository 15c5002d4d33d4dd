"""Streaming field store: continuous ingest into resident temporal summaries.

A :class:`StreamFieldStore` is a :class:`~repro_torch.store.FieldStore` that
also registers :class:`~repro_torch.stream.TemporalField` streams and keeps
their merged :class:`~repro_torch.core.oplib.TemporalSummary` intermediates
resident in the same byte-budgeted LRU.  The streaming contract
(DESIGN.md §9):

* **append is incremental** — ``append(id, data)`` compresses the new slab
  and, for every *resident* summary cell of that id (full-field and each
  cached region window), reconstructs **only the new slab** and merges its
  integer summary into the resident one (``oplib.merge_summaries``) — a
  replace-in-place of the cache entry, never an invalidate-and-rebuild.
  The incremental-vs-recompute decision is costed through the planner
  (:func:`repro_torch.analytics.planner.plan_refresh`); with a resident
  summary the incremental path is never dearer, and without one the
  rebuild is deferred to the next query.
* **appends never invalidate unrelated materializations** — entries of
  other ids (and the spatial materializations of ordinary fields) are
  untouched.
* **eviction degrades to recompute, not to wrong answers** — a summary the
  budget rejects is rebuilt from all slabs on the next query, bit-identical
  to the incrementally maintained one (integer merges are associative).
"""
from __future__ import annotations

from ..core import Stage, oplib
from ..core import region as region_mod
from ..core.oplib import TemporalSummary
from ..store import FieldStore

from .temporal import TemporalField

#: cache-key tag of temporal summary cells: one summary per (id, region)
#: serves every stage its feasibility row allows (the integers are the same).
TEMPORAL_TAG = "__temporal__"


class StreamFieldStore(FieldStore):
    """Field store with streaming ingest (see module docstring).

    ``engine`` (a :class:`~repro_torch.analytics.BatchedAnalytics`,
    defaulting to the process-wide one) runs the per-slab summarizer and
    the merge; ``cost_model`` feeds the planner's summarize-stage
    choice and the incremental-vs-recompute costing.
    """

    def __init__(self, cache_bytes: int = 256 << 20, *, engine=None,
                 cost_model=None):
        super().__init__(cache_bytes)
        self._engine_override = engine
        self.cost_model = cost_model
        #: monotone counters of streaming refresh work
        self.incremental_merges = 0
        self.summary_rebuilds = 0

    @property
    def engine(self):
        if self._engine_override is not None:
            return self._engine_override
        from ..analytics.engine import default_engine
        return default_engine

    # -- temporal registry --------------------------------------------------
    def put(self, field_id, field, *, replace=False):
        if isinstance(field, TemporalField):
            raise TypeError(
                "TemporalField streams register via put_temporal(), not put()")
        return super().put(field_id, field, replace=replace)

    def put_temporal(self, field_id: str, tf: TemporalField, *,
                     replace: bool = False) -> str:
        """Register an append-only temporal field under ``field_id``."""
        if not isinstance(field_id, str) or not field_id:
            raise ValueError(
                f"field id must be a non-empty string, got {field_id!r}")
        if not isinstance(tf, TemporalField):
            raise TypeError(
                f"expected a TemporalField, got {type(tf).__name__}")
        if field_id in self._fields:
            if not replace:
                raise ValueError(
                    f"field id {field_id!r} already registered "
                    "(pass replace=True to overwrite)")
            self.invalidate(field_id)
        self._fields[field_id] = tf
        return field_id

    def is_temporal(self, field_id: str) -> bool:
        return isinstance(self.get(field_id), TemporalField)

    def _temporal(self, field_id: str) -> TemporalField:
        tf = self.get(field_id)
        if not isinstance(tf, TemporalField):
            raise TypeError(
                f"field id {field_id!r} is not a temporal field; append() "
                "and temporal ops need a TemporalField (see put_temporal)")
        return tf

    def _temporal_key(self, field_id: str, tf: TemporalField,
                      region) -> tuple:
        norm = (region_mod.normalize_region(region, tf.shape)
                if region is not None else None)
        return (field_id, TEMPORAL_TAG, norm)

    def _summary_stage(self, tf: TemporalField, region=None) -> Stage:
        """Cheapest feasible stage to reconstruct a slab summary at (the
        summary itself is stage-independent — only the route is costed)."""
        from ..analytics.planner import plan_stage
        slab0 = tf.slabs[0] if tf.slabs else None
        lifted = (oplib.temporal_region(slab0, region)
                  if region is not None and slab0 is not None else None)
        return plan_stage(tf.scheme, "tmean", "auto", self.cost_model,
                          region=lifted, field=slab0)

    # -- streaming ingest ---------------------------------------------------
    def append(self, field_id: str, data) -> int:
        """Ingest one time slab and incrementally refresh every resident
        summary of ``field_id`` (reconstructing only the new slab); returns
        the slab index.  Cells evicted or never built stay absent — the
        next query rebuilds them."""
        from ..analytics.planner import plan_refresh

        tf = self._temporal(field_id)
        idx = tf.append(data)
        slab = tf.slabs[idx]
        resident = self._resident_summary_keys(field_id)
        plan = plan_refresh(tf.scheme, self._summary_stage(tf),
                            tf.n_slabs, self.cost_model,
                            summary_resident=bool(resident))
        if plan.mode != "incremental":
            return idx  # nothing to merge into: rebuild on the next query
        for key in resident:
            self._refresh_resident(key, slab, tf)
        return idx

    def _resident_summary_keys(self, field_id: str) -> list[tuple]:
        """Resident temporal-summary cache keys of one id (full-field and
        each cached region window)."""
        return [k for k in self._cache
                if k[0] == field_id and k[1] == TEMPORAL_TAG]

    def _slab_summary(self, tf: TemporalField, slab, region) -> TemporalSummary:
        """One slab's summary over ``region``'s window — the per-append
        reconstruction unit."""
        part = self.engine.summarize(
            [slab], self._summary_stage(tf, region), region=region)
        return oplib.map_summaries(lambda x: x[0], part)

    def _refresh_resident(self, key: tuple, slab, tf: TemporalField) -> None:
        """Merge one new slab into one resident summary cell,
        replace-in-place (LRU-refreshing)."""
        old = self._cache.get(key)
        if old is None:
            # refreshing an earlier cell evicted this one under budget
            # pressure — it is no longer resident, so there is nothing
            # to merge into; the next query rebuilds it
            return
        merged = self.engine.merge_summaries(
            old, self._slab_summary(tf, slab, key[2]))
        self._insert(key, merged)
        self.incremental_merges += 1

    # -- serving ------------------------------------------------------------
    def temporal_summary(self, field_id: str, *, region=None,
                         stage=None) -> TemporalSummary:
        """Merged summary over every appended slab of ``field_id``.

        A resident cell is a hit (any stage — the integers are identical);
        a miss rebuilds from all slabs at ``stage`` (or the planner's
        cheapest feasible) and inserts the result, budget permitting.
        """
        tf = self._temporal(field_id)
        if not tf.slabs:
            raise ValueError(
                f"temporal field {field_id!r} has no appended slabs")
        key = self._temporal_key(field_id, tf, region)
        m = self._peek_hit(key)
        if m is not None:
            return m
        self.stats.misses += 1
        if stage is None:
            stage = self._summary_stage(tf, region)
        merged = self._build_summary(tf, Stage(stage), region)
        self.summary_rebuilds += 1
        self._insert(key, merged)
        return merged

    def _build_summary(self, tf: TemporalField, stage: Stage,
                       region) -> TemporalSummary:
        """Summarize every slab and merge in temporal order — one algorithm
        for the storeless and store-miss paths (`query._cold_summary`)."""
        from .query import _cold_summary

        return _cold_summary(tf, stage, region, self.engine)[0]
