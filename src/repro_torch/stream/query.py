"""Temporal query front-end: incremental analytics over appended streams.

``repro_torch.analytics.query`` delegates here whenever the op set is
temporal (``tdelta`` / ``tmean`` / ``tmin`` / ``tmax`` / ``tstd``), so
clients use one ``query()`` for both workloads.  Execution is three engine
calls (DESIGN.md §9): the per-slab summarizer (only on store misses — a hot
stream serves straight from its resident merged summary), the pairwise
merge, and the op-set postlude.
"""
from __future__ import annotations
from collections.abc import Sequence

from functools import reduce

from ..core import Stage, layout_key, oplib

from .temporal import TemporalField


def _cold_summary(tf: TemporalField, stage: Stage, region, engine):
    """Storeless path: summarize every slab (batched per layout) and merge
    in temporal order.  Returns ``(summary, n_calls)`` where ``n_calls``
    counts the engine calls issued (one batched summarize per layout group
    plus one merge per fold step), so callers report dispatch accounting
    uniformly with the spatial path."""
    groups: dict[tuple, list[int]] = {}
    for i, slab in enumerate(tf.slabs):
        groups.setdefault(layout_key(slab), []).append(i)
    parts = [None] * len(tf.slabs)
    for indices in groups.values():
        stacked = engine.summarize([tf.slabs[i] for i in indices], stage,
                                   region=region)
        for j, i in enumerate(indices):
            parts[i] = oplib.map_summaries(lambda x, _j=j: x[_j], stacked)
    return (reduce(engine.merge_summaries, parts),
            len(groups) + max(0, len(parts) - 1))


def query_temporal(fields: Sequence, op: str | Sequence[str],
                   stage: Stage | str | int = "auto", *,
                   axis: int = 0, region=None, cost_model=None,
                   engine=None, store=None):
    """Run a temporal op set over one or more temporal fields (or store ids).

    Mirrors :func:`repro_torch.analytics.query.query`: returns a
    ``QueryResult`` with per-field values (a dict per field for op sets) in
    input order.  ``region`` is spatial; ``stage`` validates against the
    temporal feasibility rows (explicit infeasible stages raise before any
    work) and routes the *reconstruction* on cold summaries — results are
    bit-identical at every feasible stage because the summaries are
    integer-exact.
    """
    from ..analytics.engine import default_engine
    from ..analytics.planner import plan_stages
    from ..analytics.query import QueryResult

    single = isinstance(op, str)
    names = oplib.canonical_ops(op)
    if not oplib.is_temporal_ops(names):
        raise ValueError(f"{names} is not a temporal op set")
    if engine is None:
        engine = default_engine
    del axis  # temporal reductions are always over the time axis

    hits0, misses0 = ((store.stats.hits, store.stats.misses)
                      if store is not None else (0, 0))
    values, stages = [], []
    n_dispatches = 0
    group_sigs = set()  # layout batches, mirroring the spatial n_batches
    for item in fields:
        fid: str | None = None
        if isinstance(item, str):
            if store is None:
                raise ValueError(
                    f"field id {item!r} given but no store= attached to "
                    "the query")
            tf = store.get(item)
            fid = item
        else:
            tf = item
        if not isinstance(tf, TemporalField):
            raise TypeError(
                f"temporal ops {names} run over TemporalField streams; got "
                f"{type(tf).__name__}" + (f" for id {fid!r}" if fid else ""))
        if not tf.slabs:
            raise ValueError(
                "temporal field has no appended slabs"
                + (f" (id {fid!r})" if fid else ""))
        slab0 = tf.slabs[0]
        lifted = (oplib.temporal_region(slab0, region)
                  if region is not None else None)
        plan = plan_stages(tf.scheme, names, stage,
                           cost_model or engine.cost_model,
                           region=lifted, field=slab0)
        # temporal op sets always share one summary, so a fused stage always
        # exists — but a calibrated cost model may still price per-op stages
        # cheaper (plan.fused None).  Per-op stages would reconstruct the
        # same integers several times for identical results, so collapse to
        # one shared feasible stage: the set's cheapest per-op choice.
        s = plan.fused
        if s is None:
            s = min((st for _, st in plan.stages), key=int)
        group_sigs.add((tf.layout_sig(), fid is not None))
        if fid is not None:
            if not hasattr(store, "temporal_summary"):
                raise TypeError(
                    "temporal ids need a StreamFieldStore "
                    "(repro_torch.stream.StreamFieldStore)")
            summary = store.temporal_summary(fid, region=region, stage=s)
        else:
            summary, n_cold = _cold_summary(tf, s, region, engine)
            n_dispatches += n_cold
        out = engine.run_temporal(names, summary, tf.eps)
        n_dispatches += 1
        values.append(out[names[0]] if single else out)
        stages.append(s if single else {n: s for n in names})
    store_hits = store_misses = 0
    if store is not None:
        store_hits = store.stats.hits - hits0
        store_misses = store.stats.misses - misses0
    return QueryResult(values=values, stages=stages,
                       op=op if single else names,
                       n_batches=len(group_sigs), n_dispatches=n_dispatches,
                       store_hits=store_hits, store_misses=store_misses)
