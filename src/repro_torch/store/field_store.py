"""Byte-budgeted store of encoded fields and their materialized stages.

A :class:`FieldStore` is the serving-side registry that turns "one
reconstruction per call" into "one reconstruction per field lifetime":

* **fields** — encoded/compressed containers registered under string ids,
  so analytics clients name data instead of shipping arrays;
* **materializations** — an LRU cache of :class:`MaterializedStage`
  intermediates keyed by ``(field id, stage, region, closure)``, bounded by
  a device-byte budget, with hit / miss / eviction accounting
  (:class:`StoreStats`);
* **planner input** — :meth:`cached_stages` reports which stages of a
  field are resident for a given op set, so the cache-aware cost model
  (``repro_torch.analytics.planner``) can drop the reconstruction term and route
  ``stage="auto"`` to an already-materialized stage.

Invalidation rules (DESIGN.md §7): re-registering or removing a field id
drops every materialization derived from it; materializations are immutable
otherwise (fields are, too — compression is content-addressed by the
caller's id discipline).
"""
from __future__ import annotations
from collections.abc import Iterable, Sequence

import dataclasses
from collections import OrderedDict

from ..core import Compressed, Encoded, Stage, oplib
from ..core import region as region_mod
from ..core.region import Closure

from .materialized import (MaterializedStage, materialize,
                           materialized_nbytes, storage_stage)

Field = Compressed | Encoded

#: stages a materialization serves (① is always resident in the container;
#: ④ is served by the stage-③ integer intermediate — see ``storage_stage``)
MATERIALIZABLE = (Stage.P, Stage.Q, Stage.F)


@dataclasses.dataclass
class StoreStats:
    """Cumulative cache accounting (monotone counters).

    ``evictions`` counts entries dropped from the cache for any reason —
    budget pressure *and* id invalidation — so it tracks resident-set
    churn; ``rejected`` counts cells that never became resident (larger
    than the whole budget), so it flags fields the budget cannot serve.
    """

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    rejected: int = 0


class FieldStore:
    """Registry of encoded fields + byte-budgeted LRU cache of their
    materialized stages.

    ``cache_bytes`` bounds the *device* bytes of resident intermediates
    (fields themselves are not counted — they are the store's contents, not
    its cache).  An entry larger than the whole budget is never retained
    (counted as a *rejection*, :attr:`StoreStats.rejected` — it was never
    resident, so it is not an eviction), so one huge field cannot starve
    the cache into thrash; :meth:`seed` declines such cells without even
    computing them.
    """

    def __init__(self, cache_bytes: int = 256 << 20):
        if cache_bytes < 0:
            raise ValueError("cache_bytes must be >= 0")
        self.cache_bytes = cache_bytes
        self._fields: dict[str, Field] = {}
        self._cache: OrderedDict[tuple, MaterializedStage] = OrderedDict()
        self._bytes = 0
        self.stats = StoreStats()

    # -- field registry -----------------------------------------------------
    def put(self, field_id: str, field: Field, *, replace: bool = False) -> str:
        """Register ``field`` under ``field_id``.

        Replacing an existing id requires ``replace=True`` and invalidates
        every materialization derived from the old field.
        """
        if not isinstance(field_id, str) or not field_id:
            raise ValueError(f"field id must be a non-empty string, got {field_id!r}")
        if not isinstance(field, (Compressed, Encoded)):
            raise TypeError(
                f"expected a Compressed/Encoded field, got {type(field).__name__}")
        if field_id in self._fields:
            if not replace:
                raise ValueError(
                    f"field id {field_id!r} already registered "
                    "(pass replace=True to overwrite)")
            self.invalidate(field_id)
        self._fields[field_id] = field
        return field_id

    def get(self, field_id: str) -> Field:
        try:
            return self._fields[field_id]
        except KeyError:
            raise KeyError(
                f"unknown field id {field_id!r}; registered ids: "
                f"{sorted(self._fields) or '(none)'}") from None

    def remove(self, field_id: str) -> None:
        """Unregister a field and drop its materializations."""
        self.get(field_id)  # uniform unknown-id error
        self.invalidate(field_id)
        del self._fields[field_id]

    def __contains__(self, field_id: str) -> bool:
        return field_id in self._fields

    def __len__(self) -> int:
        return len(self._fields)

    def ids(self) -> tuple[str, ...]:
        return tuple(self._fields)

    # -- materialization cache ---------------------------------------------
    @staticmethod
    def _key(field_id: str, stage: Stage, region, closure: Closure) -> tuple:
        return (field_id, storage_stage(stage), region, closure)

    def _canonical(self, field: Field, stage: Stage, region, closure: Closure):
        norm = (region_mod.normalize_region(region, field.shape)
                if region is not None else None)
        return norm, region_mod.canonical_closure(field.scheme, closure, norm)

    @property
    def cache_bytes_in_use(self) -> int:
        return self._bytes

    @property
    def cache_entries(self) -> int:
        return len(self._cache)

    def _peek_hit(self, key: tuple) -> MaterializedStage | None:
        """Resident entry for ``key`` (bumping LRU order and the hit
        counter), or ``None`` without counting anything."""
        m = self._cache.get(key)
        if m is not None:
            self._cache.move_to_end(key)
            self.stats.hits += 1
        return m

    def lookup(self, field_id: str, stage: Stage, *, region=None,
               closure: Closure = "cover") -> MaterializedStage | None:
        """Cache lookup (counts a hit or a miss; hits refresh LRU order)."""
        field = self.get(field_id)
        norm, closure = self._canonical(field, stage, region, closure)
        m = self._peek_hit(self._key(field_id, stage, norm, closure))
        if m is None:
            self.stats.misses += 1
        return m

    def ensure(self, field_id: str, stage: Stage, *, region=None,
               closure: Closure = "cover") -> MaterializedStage:
        """Resident materialization for one cache cell: a hit returns it, a
        miss builds it (the *one* reconstruction of the field's lifetime,
        budget permitting) and inserts it."""
        m = self.lookup(field_id, stage, region=region, closure=closure)
        if m is not None:
            return m
        field = self.get(field_id)
        norm, closure = self._canonical(field, stage, region, closure)
        m = materialize(field, stage, region=region, closure=closure)
        self._insert(self._key(field_id, stage, norm, closure), m)
        return m

    def seed(self, field_id: str, stage: Stage, *, region=None,
             closure: Closure = "cover") -> MaterializedStage | None:
        """:meth:`ensure`, but declining cells that could never be retained.

        A materialization larger than the whole budget would be rebuilt on
        *every* query — strictly worse than running storeless — so a miss
        first checks the exact predicted size (:func:`materialized_nbytes`,
        static geometry only) and returns ``None``, signalling the caller
        to fall back to unseeded execution.  A hit skips the size check:
        residency already proved the fit."""
        field = self.get(field_id)
        norm, closure = self._canonical(field, stage, region, closure)
        key = self._key(field_id, stage, norm, closure)
        m = self._peek_hit(key)
        if m is not None:
            return m
        if materialized_nbytes(field, stage, region=region,
                               closure=closure) > self.cache_bytes:
            self.stats.rejected += 1
            return None
        self.stats.misses += 1
        m = materialize(field, stage, region=region, closure=closure)
        self._insert(key, m)
        return m

    def _insert(self, key: tuple, m) -> None:
        """Insert (or replace) one cache entry, keeping ``_bytes`` equal to
        the sum of resident ``nbytes`` through every path.

        The replace path subtracts the old entry's bytes exactly once (the
        ``pop`` removes it before the eviction loop can see it, so it can
        never be double-subtracted as both replacement and victim), and the
        eviction loop walks from the LRU end but never touches ``key``
        itself — the just-inserted entry must not be its own victim even if
        a future refactor changes its position in the order.
        """
        nb = m.nbytes
        old = self._cache.pop(key, None)
        if old is not None:
            self._bytes -= old.nbytes
        if nb > self.cache_bytes:
            # never retained: computed for this call, dropped immediately.
            # A *replaced* entry stays dropped — keeping the stale value
            # would serve outdated intermediates (fatal for streaming
            # summaries, which are replaced on every append).
            self.stats.rejected += 1
            if old is not None:
                self.stats.evictions += 1
            return
        self._cache[key] = m
        self._bytes += nb
        while self._bytes > self.cache_bytes:
            victim_key = next(iter(self._cache))
            if victim_key == key:  # never evict the entry just inserted
                break
            self._bytes -= self._cache.pop(victim_key).nbytes
            self.stats.evictions += 1

    def invalidate(self, field_id: str) -> int:
        """Drop every materialization of ``field_id`` (counted as
        evictions — resident-set churn an operator should see); returns
        the count."""
        victims = [k for k in self._cache if k[0] == field_id]
        for k in victims:
            self._bytes -= self._cache.pop(k).nbytes
        self.stats.evictions += len(victims)
        return len(victims)

    # -- planner input ------------------------------------------------------
    def is_resident(self, field_id: str, stage: Stage, *, region=None,
                    closure: Closure = "cover") -> bool:
        """Pure residency peek for one exact ``(stage, region, closure)``
        cell — the expression planner's cache-awareness probe (expression
        closures join over a DAG's consumer set, so they don't reduce to an
        op-set's :meth:`cached_stages` row).  Neither the LRU order nor the
        hit/miss counters move."""
        field = self.get(field_id)
        norm, closure = self._canonical(field, stage, region, closure)
        return self._key(field_id, stage, norm, closure) in self._cache

    def cached_stages(self, field_ids: str | Sequence[str],
                      ops: str | Iterable[str], *, region=None,
                      axis: int = 0) -> frozenset[Stage]:
        """Stages at which ``ops`` over ``field_ids`` would be served from
        resident materializations.

        For a field-arity op set pass one id; for a vector-arity set
        (``divergence``/``curl``) pass the component ids — a stage counts
        only when *every* component's cell is resident.  Pure peek: neither
        the LRU order nor the hit/miss counters move (planning must not
        distort serving statistics).
        """
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
                if self._key(fid, stage, norm, cl) not in self._cache:
                    resident = False
                    break
            if resident:
                out.add(stage)
        return frozenset(out)
