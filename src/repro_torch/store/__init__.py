"""Materialized-stage field store: intermediate representations as values.

* :class:`MaterializedStage` / :func:`materialize` hold one ``(field, stage,
  region, closure)`` intermediate — the stage-② residual sub-field or the
  stage-③ integers — on the field's device; ``materialized_nbytes`` predicts
  its size from the plan alone;
* :class:`FieldStore` — string-id registry of compressed fields plus a
  byte-budgeted LRU cache of their materializations with hit / miss /
  eviction accounting (:class:`StoreStats`).

``repro_torch.analytics.query(..., store=)`` resolves ids through it, plans
cache-aware (a resident stage prices at postlude-only cost) and seeds the
batched engine's programs from the resident intermediates.
"""
from .field_store import MATERIALIZABLE, FieldStore, StoreStats
from .materialized import (MaterializedStage, materialize,
                           materialized_nbytes, serves, storage_stage)

__all__ = ["FieldStore", "MATERIALIZABLE", "MaterializedStage", "StoreStats",
           "materialize", "materialized_nbytes", "serves", "storage_stage"]
