"""Analytics serving: batched homomorphic analytics requests.

The continuous-batching contract (``add_request`` / ``step`` /
``run_until_drained``) for homomorphic analytics over compressed fields.
Each ``step`` drains the queue, groups requests by ``(op set, stage
directive, axis)`` and — via the query front-end — by field layout, and
issues one batched engine call per group, so N concurrent requests
over same-layout fields cost one dispatch instead of N.  A request may name
*several* ops (``op=["mean", "std"]``): the fused plan pays one stage
reconstruction for the whole set and the request resolves to a result dict.
The op-set component of the group signature is canonical (order-insensitive),
so ``["std", "mean"]`` and ``["mean", "std"]`` batch — and compile — together.

With a :class:`repro_torch.store.FieldStore` attached, ``AnalyticsRequest.fields``
may name registered field *ids* (strings — component ids too, for
``divergence``/``curl``) instead of shipping containers: the frontend
resolves ids for grouping and serves the group through the store, so
repeated queries of a hot field reuse its materialized stage reconstruction
(``repro_torch.analytics.query`` seeds the group's call) and clients stop
shipping arrays entirely — the serve-millions contract.  Unknown ids reject
only their own request.

With a streaming store (:class:`repro_torch.stream.StreamFieldStore`), the queue
also carries :class:`AppendRequest` — producers ship raw timestep batches
against a temporal field id; each serving step applies appends (in order)
*before* its analytics, and temporal ops (``tmean``/``tdelta``/...) over
the same ids answer from incrementally merged summaries.  Every request is
always either answered or rejected with a structured error; a malformed
request (unknown id, empty op set, out-of-bounds region, duplicate vector
component ids) never poisons another request's group.

Spans: each ``step`` records the port's spans (:mod:`repro_torch.trace`)
while ``torch.profiler`` runs, and costs a flag read per span when none
does.  To see them, run the frontend under
``torch.profiler.profile(activities=[ProfilerActivity.CPU,
ProfilerActivity.CUDA])`` and read ``prof.events()`` or write
``prof.export_chrome_trace(path)``: ``hsz.serve.step`` holds
``hsz.serve.group_by`` and one ``hsz.query`` per group, which holds the
planner's (``hsz.plan``, ``hsz.store``), the engine's (``hsz.engine.*``)
and, inside the program, ``hsz.op`` > ``hsz.prelude`` > ``hsz.decode``
and ``hsz.kernel.launch`` (``hsz.op.torch`` around a torch rule that runs
where the cell's fused rule declined the context).
"""
from __future__ import annotations
from collections.abc import Sequence

import dataclasses
import warnings
from typing import Any

from .. import trace
from ..analytics import CostModel, query
from ..analytics.engine import BatchedAnalytics
from ..analytics.query import _group_signature, _query_opset, _resolve_item
from ..core import Compressed, Encoded, Stage, oplib
from ..core import expr as expr_mod
from ..core import region as region_mod

Field = Compressed | Encoded


def _region_signature(req: "AnalyticsRequest", resolved=None):
    """Normalized region for grouping, so equivalent specs (slices vs tuples
    vs numpy ints) batch into one dispatch.  ``resolved`` is the id-free
    view of ``req.fields`` (defaults to ``req.fields`` for id-less
    requests).  Raises on malformed regions — the caller's per-request
    guard turns that into a rejection."""
    if req.region is None:
        return None
    if resolved is None:
        resolved = req.fields
    ops = oplib.canonical_ops(req.op)
    first = resolved[0] if oplib.is_vector_ops(ops) else resolved
    return region_mod.normalize_region(req.region, first.shape)


@dataclasses.dataclass
class AnalyticsRequest:
    """One analytics request: expression DAGs, or a flat (field, op) pair.

    The expression form is primary: ``exprs`` is one
    :class:`repro_torch.core.expr.Expr` (or a sequence) whose leaves carry the
    data — containers, component bundles, or (with a store-attached
    frontend) registered field ids.  Cross-field derived quantities
    (vorticity from u and v, ensemble deltas) are one request; same-step
    expression requests with the same stage directive and region fuse into
    one compiled program, sharing leaf preludes across requests.

    The flat form — ``fields`` + ``op`` — remains for back-compat:
    ``fields`` carries (or names) one possibly-vector field and ``op`` one
    op name.  The op-*set* spelling (``op=["mean", "std"]``) is deprecated
    in favor of expressions and warns.  With a streaming store
    (:class:`repro_torch.stream.StreamFieldStore`), temporal ops (``tmean``,
    ``tdelta``, ...) over a temporal field id query the appended stream in
    either form.
    """

    uid: int
    fields: Field | str | Sequence[Field | str] | None = None
    op: str | Sequence[str] = "mean"  # one op, or a fused op set
    stage: Stage | str | int = "auto"
    axis: int = 0                          # derivative only
    region: Any = None                     # per-axis window, or None for full
    exprs: Any = None                      # Expr or sequence of Expr roots
    result: Any = None                     # array, or {op: array} for op sets
    result_stage: Any = None               # Stage, or {op: Stage} for op sets
    error: str | None = None            # set instead of result on rejection
    done: bool = False


@dataclasses.dataclass
class AppendRequest:
    """Streaming ingest: append one time slab to a registered temporal field.

    The client-side half of the streaming contract — producers ship raw
    timestep batches (``data``: shape ``(k, *spatial)``) against a field
    *id*; the frontend's :class:`repro_torch.stream.StreamFieldStore` compresses
    the slab and incrementally refreshes the id's resident temporal
    summaries (reconstructing only the new slab).  Within one serving step
    appends are applied before analytics, so an append+query pair enqueued
    together observes the appended timesteps.
    """

    uid: int
    field_id: str
    data: Any                              # (timesteps, *spatial) raw values
    slab_index: int | None = None       # set on success
    error: str | None = None            # set instead on rejection
    done: bool = False


class AnalyticsFrontend:
    """Batching frontend for analytics requests (no model, no slots: the
    batch axis is formed per step from whatever is queued).  ``store``
    enables id-addressed requests and materialized-stage reuse."""

    def __init__(self, cost_model: CostModel | None = None,
                 max_batch: int = 256, store=None):
        self.engine = BatchedAnalytics(cost_model)
        self.max_batch = max_batch
        self.store = store
        self._queue: list[AnalyticsRequest] = []

    def _resolve_fields(self, req: AnalyticsRequest, vector: bool):
        """Id-free view of a request's fields (for grouping signatures);
        raises on unknown ids / ids without a store (-> rejection).  One
        resolver for the whole stack: this reuses the query front-end's."""
        resolved, _ = _resolve_item(req.fields, self.store, vector)
        return resolved

    def add_request(self, req: AnalyticsRequest | "AppendRequest") -> None:
        self._queue.append(req)

    # -- one serving step --------------------------------------------------
    @staticmethod
    def _reject(req, exc: Exception):
        req.error = f"{type(exc).__name__}: {exc}"
        req.done = True
        return req

    def _apply_append(self, req: AppendRequest) -> AppendRequest:
        """Ingest one slab through the streaming store (rejections are
        per-request, like analytics)."""
        try:
            if self.store is None or not hasattr(self.store, "append"):
                raise ValueError(
                    "append requests need a streaming store "
                    "(repro_torch.stream.StreamFieldStore) attached to the "
                    "frontend")
            req.slab_index = self.store.append(req.field_id, req.data)
        except Exception as e:  # unknown id / shape mismatch / no store
            return self._reject(req, e)
        req.done = True
        return req

    @trace.spanned("hsz.serve.step")
    def step(self) -> list[AnalyticsRequest | AppendRequest]:
        """Serve up to ``max_batch`` queued requests; returns those finished.

        Appends are applied first (in arrival order — ingest precedes the
        step's analytics), then analytics requests are grouped by
        (canonical op set, stage directive, axis, region, field layout), so
        a rejection — infeasible stage, malformed fields, duplicate ids,
        out-of-bounds region — only affects its own request or group;
        everything servable in the step is served; the engine keeps no
        state between calls, so a rejected request leaves nothing behind.
        """
        batch, self._queue = self._queue[:self.max_batch], self._queue[self.max_batch:]
        finished: list[AnalyticsRequest | AppendRequest] = []
        analytics_batch: list[AnalyticsRequest] = []
        for req in batch:
            if isinstance(req, AppendRequest):
                finished.append(self._apply_append(req))
            else:
                analytics_batch.append(req)
        groups, expr_groups = self._group(analytics_batch, finished)
        for group in groups.values():
            self._serve_group(group, finished)
        for egroup in expr_groups.values():
            self._serve_expr_group(egroup, finished)
        return finished

    @trace.spanned("hsz.serve.group_by")
    def _group(self, analytics_batch: list[AnalyticsRequest], finished: list):
        """Group the step's analytics requests: ``(groups, expr_groups)``;
        a malformed request is rejected into ``finished``."""
        groups: dict[tuple, list[AnalyticsRequest]] = {}
        # expression requests: group value is [(request, its roots), ...]
        expr_groups: dict[tuple, list[tuple[AnalyticsRequest, list]]] = {}
        for req in analytics_batch:
            if req.exprs is not None:
                try:
                    if req.fields is not None:
                        raise TypeError(
                            "an expression request carries its fields inside "
                            "the expressions; do not also set .fields")
                    roots = ([req.exprs]
                             if isinstance(req.exprs, expr_mod.Expr)
                             else list(req.exprs))
                    expr_mod.analyze(roots)  # per-request validation
                    # repr-canonical region: equivalent-but-differently-
                    # spelled windows may land in separate (still correct)
                    # groups — exprs carry no single shape to normalize by
                    sig = (str(req.stage), repr(req.region))
                except Exception as e:
                    finished.append(self._reject(req, e))
                    continue
                expr_groups.setdefault(sig, []).append((req, roots))
                continue
            if req.fields is None:
                finished.append(self._reject(req, TypeError(
                    "request needs exprs= or the flat fields/op pair")))
                continue
            if not isinstance(req.op, str):
                warnings.warn(
                    "the AnalyticsRequest.op op-set form is deprecated; "
                    "send AnalyticsRequest(exprs=[...]) expressions instead "
                    "(repro_torch.core.expr)", DeprecationWarning,
                    stacklevel=5)  # step()'s caller, past the span wrappers
            try:
                ops = oplib.canonical_ops(req.op)
                vector = oplib.is_vector_ops(ops)
                resolved = self._resolve_fields(req, vector)
                sig = (ops, str(req.stage), req.axis,
                       _region_signature(req, resolved),
                       _group_signature(resolved, vector))
            except Exception as e:  # unknown op / id / malformed fields
                finished.append(self._reject(req, e))
                continue
            groups.setdefault(sig, []).append(req)
        return groups, expr_groups

    @trace.spanned("hsz.query")
    def _serve_group(self, group: list[AnalyticsRequest], finished: list):
        """One flat group's query; its requests go to ``finished``."""
        try:
            # original (possibly id-bearing) fields go to the query:
            # ids keep their cache identity, so hot fields are served
            # from materialized stages
            res = _query_opset([r.fields for r in group], group[0].op,
                               group[0].stage, axis=group[0].axis,
                               region=group[0].region, engine=self.engine,
                               store=self.store)
        except Exception as e:
            # reject only this group (bad op / infeasible stage / ...);
            # every request is always either answered or errored
            finished.extend(self._reject(r, e) for r in group)
            return
        for req, value, stage in zip(group, res.values, res.stages):
            # a group may mix op="mean" and op=["mean"] requests (same
            # canonical signature): give each the form it asked for
            if isinstance(req.op, str) and isinstance(value, dict):
                value, stage = value[req.op], stage[req.op]
            elif not isinstance(req.op, str) and not isinstance(value, dict):
                (name,) = oplib.canonical_ops(req.op)
                value, stage = {name: value}, {name: stage}
            req.result = value
            req.result_stage = stage
            req.done = True
            finished.append(req)

    @trace.spanned("hsz.query")
    def _serve_expr_group(self, egroup: list, finished: list):
        """One expression group's fused query; its requests go to
        ``finished``."""
        reqs = [r for r, _ in egroup]
        all_roots = [root for _, roots in egroup for root in roots]
        try:
            # one fused program per group: leaves shared across requests
            # dedupe into one prelude each
            res = query(exprs=all_roots, stage=reqs[0].stage,
                        region=reqs[0].region, engine=self.engine,
                        store=self.store)
        except Exception as e:
            finished.extend(self._reject(r, e) for r in reqs)
            return
        i = 0
        for req, roots in egroup:
            vals = res.values[i:i + len(roots)]
            stgs = res.stages[i:i + len(roots)]
            i += len(roots)
            single = isinstance(req.exprs, expr_mod.Expr)
            req.result = vals[0] if single else vals
            req.result_stage = stgs[0] if single else stgs
            req.done = True
            finished.append(req)

    def run_until_drained(self) -> list[AnalyticsRequest]:
        finished: list[AnalyticsRequest] = []
        while self._queue:
            finished.extend(self.step())
        return finished
