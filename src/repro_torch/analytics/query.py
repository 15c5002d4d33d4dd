"""Query front-end: analytics over arbitrary collections of compressed fields.

``query(exprs=[...])`` is the primary surface: expression DAGs
(:mod:`repro_torch.core.expr`) whose whole batch runs as one engine call
with one stage-reconstruction prelude per distinct leaf.  The flat form
``query(fields, op_or_ops)`` (deprecated) accepts any mix of layouts
(different datasets, shapes, schemes) and a single op or an op *set*, groups
the fields by their static layout signature, plans the execution stage(s)
per group — ``stage="auto"`` fuses the set onto one shared stage over the
feasible intersection (:func:`repro_torch.analytics.planner.plan_stages`) —
runs one batched program call per (group, fused plan) through the shared
:class:`BatchedAnalytics` engine, and scatters results back into input
order.  The engine receives the *resolved* plan, so stages are planned
exactly once per group.

With a :class:`repro_torch.store.FieldStore` attached (``store=``), entries of
``fields`` may be string ids (components too, for vector ops).  Id-resolved
fields are served *through the store*: planning sees which stages are
already materialized (their reconstruction term drops, so ``stage="auto"``
can flip to a resident stage), and the group's call is seeded with the
resident intermediates — a store hit pays only the op postludes.
A miss materializes through the store (one reconstruction per field
lifetime, LRU/byte-budget permitting).  Results are bit-identical to the
storeless path at the same stage.

Temporal op sets (``tdelta`` / ``tmean`` / ``tmin`` / ``tmax`` / ``tstd``)
run over appended streams (:mod:`repro_torch.stream`) through the same
``query()``: the flat form delegates to
:func:`repro_torch.stream.query.query_temporal`, and expressions join
temporal op values (store-backed or cold summaries) into their pointwise
tails.
"""
from __future__ import annotations

import dataclasses
import warnings
from collections.abc import Sequence

from .. import trace
from ..core import Compressed, Encoded, Stage, layout_key, oplib
from ..core import expr as expr_mod

from .engine import BatchedAnalytics, default_engine
from .planner import CostModel, plan_expr, plan_stages

Field = Compressed | Encoded
FieldOrVector = Field | Sequence[Field]


@dataclasses.dataclass
class QueryResult:
    """Per-field results in input order, plus the plan that produced them.

    For a single op, ``values[i]`` is that field's result and ``stages[i]``
    its execution stage; for an op set, both are dicts keyed by op name.
    ``store_hits``/``store_misses`` count materialization-cache lookups the
    query made (0 when no store was involved).
    """

    values: list                   # result (or {op: result}) per input
    stages: list                   # execution stage(s) per input
    op: str | tuple[str, ...]
    n_batches: int                 # number of field groups (layout batches)
    n_dispatches: int              # engine program calls actually issued
    store_hits: int = 0            # materializations served from cache
    store_misses: int = 0          # materializations built on demand
    exprs: tuple | None = None  # root expressions (expression queries)

    def __iter__(self):
        return iter(self.values)

    def __len__(self):
        return len(self.values)


def _group_signature(item: FieldOrVector, vector: bool) -> tuple:
    if vector:
        return tuple(layout_key(c) for c in item)
    if hasattr(item, "layout_sig"):  # TemporalField (repro_torch.stream)
        return item.layout_sig()
    return layout_key(item)


def _unbatch(batched, i: int):
    """Extract item ``i`` of a batched result (dicts per op-set results,
    tuples per component results)."""
    if isinstance(batched, dict):
        return {k: _unbatch(v, i) for k, v in batched.items()}
    if isinstance(batched, tuple):
        return tuple(b[i] for b in batched)
    return batched[i]


def _store_get(store, fid: str) -> Field:
    if store is None:
        raise ValueError(
            f"field id {fid!r} given but no store= attached to the query")
    return store.get(fid)


def _resolve_item(item, store, vector):
    """Resolve one ``fields`` entry: string ids -> store fields.

    Returns ``(resolved_item, ids)`` where ``ids`` is the field id (or the
    per-component id tuple) when the *whole* item is store-backed, else
    ``None`` — only fully id-resolved items are seedable (a raw container
    has no cache identity).
    """
    if vector:
        if isinstance(item, str):
            raise TypeError(
                f"vector ops take one field (or id) per component; got the "
                f"bare id {item!r} — pass a tuple of component ids instead")
        comps, ids = [], []
        for c in item:
            if isinstance(c, str):
                comps.append(_store_get(store, c))
                ids.append(c)
            else:
                comps.append(c)
                ids.append(None)
        named = [i for i in ids if i is not None]
        if len(set(named)) != len(named):
            # a vector field's components are distinct physical quantities;
            # repeating an id is a malformed request
            raise ValueError(
                f"duplicate field ids in vector components: {tuple(ids)}")
        all_ids = all(i is not None for i in ids)
        return tuple(comps), (tuple(ids) if all_ids else None)
    if isinstance(item, str):
        return _store_get(store, item), item
    return item, None


def query(fields: Sequence[FieldOrVector] | None = None,
          op: str | Sequence[str] | None = None,
          stage: Stage | str | int = "auto", *, axis: int = 0,
          region=None,
          cost_model: CostModel | None = None,
          engine: BatchedAnalytics | None = None,
          store=None, exprs=None, ops=None) -> QueryResult:
    """Run analytics: expression DAGs (``exprs=``) or a flat op set.

    The expression form is the primary surface: ``exprs`` is one
    :class:`repro_torch.core.expr.Expr` or a sequence of them — cross-field
    derived quantities (vorticity from u and v, ensemble deltas, ...) whose
    leaves are raw fields, component bundles or (with ``store=``) string
    field ids.  The whole batch runs as one engine call with exactly one
    stage-reconstruction prelude per distinct leaf; stages are planned
    jointly per connected component
    (:func:`repro_torch.analytics.planner.plan_expr`), cache-aware when a
    store is attached.  See :func:`_query_exprs` for the result layout.

    The flat spellings — ``query(fields, op="mean")``, ``op=[...]``, and
    the ``ops=[...]`` alias — are **deprecated** shims over the same
    machinery: they stay bit-identical (and keep their grouped-batch
    dispatch accounting) but emit a :class:`DeprecationWarning` pointing at
    the expression form.  Migration: ``query([f1, f2], "mean")`` becomes
    ``query(exprs=[expr.mean(f1), expr.mean(f2)])``.

    A temporal op set runs over ``TemporalField`` streams (or their ids in a
    :class:`repro_torch.stream.StreamFieldStore`), in the flat form and in
    expressions alike.
    """
    if exprs is not None:
        if fields is not None or op is not None or ops is not None:
            raise TypeError(
                "query(exprs=...) is the expression form; do not also pass "
                "fields/op/ops — put the fields inside the expressions")
        return _query_exprs(exprs, stage, region=region,
                            cost_model=cost_model, engine=engine,
                            store=store)
    if op is not None and ops is not None:
        raise TypeError("pass op= or ops=, not both")
    if ops is not None:
        op = ops
    if fields is None or op is None:
        raise TypeError("query() needs exprs=, or the deprecated "
                        "(fields, op) pair")
    warnings.warn(
        "query(fields, op=...) / query(fields, ops=[...]) are deprecated; "
        "build expressions instead: query(exprs=[expr.op_name(f) for f in "
        "fields]) (see repro_torch.core.expr)",
        DeprecationWarning, stacklevel=2)
    return _query_opset(fields, op, stage, axis=axis, region=region,
                        cost_model=cost_model, engine=engine, store=store)


def _query_opset(fields: Sequence[FieldOrVector],
                 op: str | Sequence[str],
                 stage: Stage | str | int = "auto", *, axis: int = 0,
                 region=None,
                 cost_model: CostModel | None = None,
                 engine: BatchedAnalytics | None = None,
                 store=None) -> QueryResult:
    """Run one analytical operation — or a fused op set — over many fields.

    Parameters
    ----------
    fields:
        For single-field ops (``mean``/``std``/``derivative``/``gradient``/
        ``laplacian``): a sequence of :class:`Compressed`/:class:`Encoded`
        fields.  For vector ops (``divergence``/``curl``): a sequence of
        vector fields, each a tuple of component fields (one per axis).
        With ``store=``, any field (or component) may instead be a string
        id registered in the store.
    op:
        One op name from :data:`repro_torch.analytics.OPS`, or a sequence of
        names (single arity per set).  An op set shares one stage
        reconstruction: ``query(fields, ["mean", "std", "laplacian"])``
        issues one batched program call per layout group and yields
        ``{op: value}`` per field, each value bit-identical to the
        corresponding single-op query.
    stage:
        ``"auto"`` (joint cheapest feasible stage per group, never one that
        raises :class:`~repro_torch.core.UnsupportedStageError`), or an
        explicit :class:`Stage` / stage name validated against the
        feasibility matrix for every op in the set.
    axis:
        Differentiation axis for ``op="derivative"``.
    region:
        Optional per-axis window (``None`` / ``slice`` / ``(start, stop)``
        per axis) applied to every field: only the covering blocks are
        decoded and the result is the op over the window
        (``repro_torch.core.region``).  Region geometry feeds stage planning
        — stage ① needs block-aligned windows, and calibrated costs scale
        by each stage's closure size.
    store:
        Optional :class:`repro_torch.store.FieldStore`.  Resolves string
        field ids, makes planning cache-aware (a store-resident stage is
        priced without its reconstruction term), and seeds the engine's
        calls from resident materializations — materializing on a miss
        so the next query hits.
    """
    single = isinstance(op, str)
    names = oplib.canonical_ops(op)
    if oplib.is_temporal_ops(names):
        # temporal op sets run over appended streams: same query() surface,
        # streaming execution path
        from ..stream.query import query_temporal
        return query_temporal(fields, op, stage, axis=axis, region=region,
                              cost_model=cost_model, engine=engine,
                              store=store)
    vector = oplib.is_vector_ops(names)
    if engine is None:
        engine = default_engine
    d_axis = axis if any(oplib.OPS[n].needs_axis for n in names) else 0

    resolved: list = []
    ids: list = []
    for item in fields:
        r, fid = _resolve_item(item, store, vector)
        for c in (r if vector else (r,)):
            if hasattr(c, "layout_sig"):  # TemporalField (repro_torch.stream)
                raise TypeError(
                    f"spatial op set {names} takes Compressed/Encoded "
                    "fields; a temporal field answers temporal ops "
                    f"({', '.join(oplib.TEMPORAL_OPS)}) instead")
        resolved.append(r)
        ids.append(fid)

    hits0, misses0 = ((store.stats.hits, store.stats.misses)
                      if store is not None else (0, 0))

    # group by static layout signature (store-backed items separately: only
    # they carry the cache identity seeding needs), preserving input order
    groups: dict[tuple, list[int]] = {}
    for i, item in enumerate(resolved):
        sig = (_group_signature(item, vector), ids[i] is not None)
        groups.setdefault(sig, []).append(i)

    values: list = [None] * len(fields)
    stages: list = [None] * len(fields)
    n_dispatches = 0
    for (_, store_backed), indices in groups.items():
        group = [resolved[i] for i in indices]
        first = group[0][0] if vector else group[0]
        cached = None
        placement = None
        if store_backed:
            with trace.span("hsz.store"):
                sets = [store.cached_stages(ids[i], names, region=region,
                                            axis=d_axis) for i in indices]
                cached = frozenset.intersection(*sets)
                # a sharded store prices reconstruction as the max over
                # participating shards (repro_torch.shard); single-device
                # stores don't expose placement_of and keep the spatial
                # fraction
                placement_of = getattr(store, "placement_of", None)
                if placement_of is not None:
                    fid0 = ids[indices[0]]
                    placement = placement_of(fid0 if isinstance(fid0, str)
                                             else fid0[0])
        plan = plan_stages(first.scheme, names, stage,
                           cost_model or engine.cost_model,
                           region=region, field=first, axis=d_axis,
                           cached=cached, placement=placement)
        seeds = None
        if (store_backed and plan.fused is not None
                and plan.fused != Stage.M):
            s = plan.fused
            with trace.span("hsz.store"):
                if vector:
                    closures = oplib.component_closures(
                        names, [c.scheme for c in group[0]], s)
                    seeds = [tuple(store.seed(fid, s, region=region,
                                              closure=cl)
                                   for fid, cl in zip(ids[i], closures))
                             for i in indices]
                    flat = [m for item in seeds for m in item]
                else:
                    cl = oplib.set_closure(names, first.scheme, s, d_axis)
                    seeds = [store.seed(ids[i], s, region=region, closure=cl)
                             for i in indices]
                    flat = seeds
            if any(m is None for m in flat):
                # some cell can never be retained under the byte budget:
                # re-materializing it every call would make the store a
                # net loss, so the whole group runs unseeded
                seeds = None
        batched = engine.run(group, op if single else names, plan,
                             axis=axis, region=region, seeds=seeds)
        n_dispatches += plan.n_dispatches
        for j, i in enumerate(indices):
            values[i] = _unbatch(batched, j)
            # fresh dict per field: callers may hold/mutate their own copy
            stages[i] = (plan.stage_of(names[0]) if single
                         else dict(plan.stages))
    store_hits = store_misses = 0
    if store is not None:
        store_hits = store.stats.hits - hits0
        store_misses = store.stats.misses - misses0
    return QueryResult(values=values, stages=stages,
                       op=op if single else names,
                       n_batches=len(groups), n_dispatches=n_dispatches,
                       store_hits=store_hits, store_misses=store_misses)


def _resolve_leaf(lf, store):
    """Resolve one leaf slot's source: string ids -> store entries.

    Returns ``(binding, fid)`` where ``fid`` is the slot's cache identity
    (id or per-component id tuple) when *fully* store-backed, else None."""
    src = lf.source
    if isinstance(src, tuple):
        comps, fids = [], []
        for c in src:
            if isinstance(c, str):
                comps.append(_store_get(store, c))
                fids.append(c)
            else:
                comps.append(c)
                fids.append(None)
        all_ids = all(f is not None for f in fids)
        return tuple(comps), (tuple(fids) if all_ids else None)
    if isinstance(src, str):
        return _store_get(store, src), src
    return src, None


def _query_exprs(exprs, stage="auto", *, region=None,
                 cost_model: CostModel | None = None,
                 engine: BatchedAnalytics | None = None,
                 store=None) -> QueryResult:
    """Execute a batch of expression DAGs as one engine call.

    ``values[i]`` is root ``i``'s result and ``stages[i]`` its component's
    jointly-planned stage; ``op`` is ``"expr"`` and ``exprs`` carries the
    roots.  ``n_dispatches`` counts program calls actually issued — one for
    the spatial DAG program (skipped when every root is purely temporal),
    plus the temporal summarize / merge / postlude calls; store counters
    mirror the flat path.  Results are bit-identical to composing the
    corresponding single-op queries at the same stage.
    """
    if engine is None:
        engine = default_engine
    single = isinstance(exprs, expr_mod.Expr)
    program = expr_mod.analyze([exprs] if single else list(exprs))

    stats = getattr(store, "stats", None) if store is not None else None
    hits0, misses0 = (stats.hits, stats.misses) if stats else (0, 0)

    bindings: list = []
    slot_ids: list = []
    for slot, lf in enumerate(program.leaves):
        b, fid = _resolve_leaf(lf, store)
        temporal = program.leaf_is_temporal(slot)
        for c in (b if isinstance(b, tuple) else (b,)):
            if hasattr(c, "layout_sig") != temporal:
                consumers = ", ".join(n for n, _ in
                                      program.leaf_consumers(slot))
                raise TypeError(
                    f"leaf {lf.key} binds a {type(c).__name__} but its "
                    f"consumers ({consumers}) are "
                    f"{'temporal' if temporal else 'spatial'} ops")
        if temporal and not b.slabs:
            raise ValueError("temporal field has no appended slabs"
                             + (f" (id {fid!r})" if fid else ""))
        bindings.append(b)
        slot_ids.append(fid)
    expr_mod.validate_bound(program, bindings, region=region)

    def slot_cached(slot: int) -> frozenset:
        fid = slot_ids[slot]
        if (fid is None or program.leaf_is_temporal(slot)
                or not hasattr(store, "is_resident")):
            return frozenset()
        b = bindings[slot]
        out = set()
        for s in (Stage.P, Stage.Q, Stage.F):
            try:
                if isinstance(b, tuple):
                    cls = expr_mod.vector_closures(
                        program, slot, [c.scheme for c in b], s)
                    ok = all(store.is_resident(f, s, region=region,
                                               closure=cl)
                             for f, cl in zip(fid, cls))
                else:
                    cl = expr_mod.leaf_closure(program, slot, b.scheme, s)
                    ok = store.is_resident(fid, s, region=region, closure=cl)
            except Exception:  # closure undefined at an infeasible stage
                continue
            if ok:
                out.add(s)
        return frozenset(out)

    with trace.span("hsz.store"):
        cached = [slot_cached(s) for s in range(len(program.leaves))]
    plan = plan_expr(program, bindings, stage,
                     cost_model or engine.cost_model,
                     region=region, cached=cached)

    # temporal op nodes: summaries reduce outside the spatial program (one
    # shared summary per stream slot), values join the DAG via `precomputed`
    n_dispatches = 0
    precomputed: dict[str, object] = {}
    summaries: dict[int, object] = {}
    for node in program.temporal_nodes:
        slot = program.slot_of(node.operand)
        tf = bindings[slot]
        s = plan.stages[program.leaf_component[slot]]
        if slot not in summaries:
            fid = slot_ids[slot]
            if fid is not None:
                if not hasattr(store, "temporal_summary"):
                    raise TypeError(
                        "temporal ids need a StreamFieldStore "
                        "(repro_torch.stream.StreamFieldStore)")
                summaries[slot] = store.temporal_summary(fid, region=region,
                                                         stage=s)
            else:
                from ..stream.query import _cold_summary
                summaries[slot], n_cold = _cold_summary(tf, s, region,
                                                        engine)
                n_dispatches += n_cold
        out = engine.run_temporal((node.name,), summaries[slot], tf.eps)
        n_dispatches += 1
        precomputed[program.serial(node)] = out[node.name]

    seeds: list = [None] * len(bindings)
    if store is not None and hasattr(store, "seed"):
        with trace.span("hsz.store"):
            for slot in range(len(program.leaves)):
                fid = slot_ids[slot]
                if fid is None or program.leaf_is_temporal(slot):
                    continue
                s = plan.stages[program.leaf_component[slot]]
                if s == Stage.M:
                    continue  # metadata is always resident in the container
                b = bindings[slot]
                if isinstance(b, tuple):
                    cls = expr_mod.vector_closures(
                        program, slot, [c.scheme for c in b], s)
                    ms = tuple(store.seed(f, s, region=region, closure=cl)
                               for f, cl in zip(fid, cls))
                    seeds[slot] = (ms if all(m is not None for m in ms)
                                   else None)
                else:
                    cl = expr_mod.leaf_closure(program, slot, b.scheme, s)
                    seeds[slot] = store.seed(fid, s, region=region,
                                             closure=cl)

    if all(program.serial(r) in precomputed for r in program.roots):
        out = tuple(precomputed[program.serial(r)] for r in program.roots)
    else:
        spatial = [None if program.leaf_is_temporal(sl) else b
                   for sl, b in enumerate(bindings)]
        out = engine.run_expr(program, spatial, plan.stages, region=region,
                              seeds=seeds, precomputed=precomputed)
        n_dispatches += 1

    store_hits = store_misses = 0
    if stats is not None:
        store_hits = stats.hits - hits0
        store_misses = stats.misses - misses0
    stages = [plan.stages[program.root_component[i]]
              for i in range(len(program.roots))]
    return QueryResult(values=list(out), stages=stages, op="expr",
                       n_batches=1, n_dispatches=n_dispatches,
                       store_hits=store_hits, store_misses=store_misses,
                       exprs=program.roots)
