"""Streaming time-slab ingestion with incremental homomorphic temporal
analytics (DESIGN.md §9).

Real scientific producers emit data as an append-only stream of timesteps.
``repro_torch.stream`` turns the serving stack into a system that absorbs
continuous writes:

* :class:`TemporalField` — an append-only sequence of error-bounded-
  compressed time slabs sharing one quantization grid; history is never
  re-encoded.
* :class:`StreamFieldStore` — a :class:`~repro_torch.store.FieldStore` whose
  ``append(id, data)`` reconstructs **only the new slab** and merges its
  integer-exact summary into each resident
  :class:`~repro_torch.core.oplib.TemporalSummary` (replace-in-place, never
  invalidate-and-rebuild).
* :func:`query_temporal` — the temporal half of
  ``repro_torch.analytics.query``: ``tdelta`` and running ``tmean`` /
  ``tmin`` / ``tmax`` / ``tstd`` over the time axis, lowered as merges of
  per-slab summaries, bit-identical to the same reduction over the full
  decompression of the concatenated field, with slab-count-stable cached
  programs.
"""
from ..core.oplib import (TEMPORAL_OPS, TemporalSummary, merge_summaries,
                          summarize_slab, summary_from_q, temporal_postlude)

from .query import query_temporal
from .store import TEMPORAL_TAG, StreamFieldStore
from .temporal import TemporalField

__all__ = [
    "TemporalField", "StreamFieldStore", "TemporalSummary", "TEMPORAL_OPS",
    "TEMPORAL_TAG", "merge_summaries", "summarize_slab", "summary_from_q",
    "temporal_postlude", "query_temporal",
]
