"""Batch executor: one batched call per op set over same-layout fields.

Many timesteps/variables of a scientific dataset share one compression
layout, so their homomorphic analytics run as *one call* over the batch
instead of one planning-and-dispatch round per field.  A call stacks the
fields once (:func:`repro_torch.core.batch_stack`, per component for vector
op sets), and their store seeds once
(:func:`repro_torch.store.materialized.stack_seeds`), and runs
:func:`repro_torch.core.oplib.compute` once on the stacked view, full field
or region: one shared stage-reconstruction prelude for the batch, in which
the decode (a region's word gather), every band-kernel pass and a seed's
stage-③ difference kernel launch once with the batch as a leading axis —
the counterpart of the grid axis Pallas prepends under the reference's
``jax.vmap``.  Results carry the leading axis — tuples per component, dicts
per op — and equal the per-field calls bit for bit (float reductions run
field by field, ``StageContext.per_field``).  Expressions
(:meth:`BatchedAnalytics.run_expr`) lower one DAG over single-field
bindings in one call.  Nothing in a call waits for the device: no
``.item()``, no copy to the host, so the kernels queue back to back on the
current stream.

Op *sets* fuse: ``run(fields, ["mean", "std", "laplacian"])`` shares one
decode per field across every postlude.  Store-seeded calls (``run(...,
seeds=)``) take the fields' materialized intermediates and run no stage
reconstruction.

Nothing is cached.  The reference keeps a jit cache of compiled programs
keyed on layout, op set, stage, region and seeds; PyTorch runs eagerly, so
there is no compiled program to reuse, and every call lowers its inputs as
they are.

Streams (``repro_torch.stream``) make three more calls through the engine:
the per-slab summarizer (:meth:`BatchedAnalytics.summarize`, one
``oplib.summarize_slab`` over the stacked slabs), the pairwise merge
(:meth:`BatchedAnalytics.merge_summaries`) and the temporal op-set postlude
(:meth:`BatchedAnalytics.run_temporal`).

Stage resolution is layered, not repeated: the engine plans only when given
``stage="auto"`` (or another directive string).  A resolved :class:`Stage`
or :class:`StageSetPlan` — e.g. from :func:`repro_torch.analytics.query.
query`, which already planned the group — is executed as-is; infeasible
explicit stages raise from the ops themselves.
"""
from __future__ import annotations

from collections.abc import Mapping, Sequence

import torch

from .. import trace
from ..core import Compressed, Encoded, Stage, batch_stack, oplib
from ..core import expr as expr_mod
from ..core import region as region_mod
from ..core.stages import check_stackable
from ..store.materialized import stack_seeds
from .planner import CostModel, StageSetPlan, plan_stages

Field = Compressed | Encoded

StageLike = Stage | str | int | StageSetPlan | Mapping[str, Stage]


class BatchedAnalytics:
    """Executes one homomorphic op set over a batch of same-layout fields.

    Module-level :data:`default_engine` is shared by
    :func:`repro_torch.analytics.query.query`.  An engine holds only its
    cost model.
    """

    def __init__(self, cost_model: CostModel | None = None):
        self.cost_model = cost_model

    # -- temporal (streaming) calls ------------------------------------------
    @trace.spanned("hsz.engine.run")
    def summarize(self, slabs: Sequence[Field], stage: Stage, *,
                  region=None) -> oplib.TemporalSummary:
        """Per-slab temporal summaries of same-layout slabs.

        The slabs are stacked once and summarized by one
        ``oplib.summarize_slab`` (each kernel launched once for the batch).
        Returns a :class:`~repro_torch.core.oplib.TemporalSummary` whose
        leaves carry a leading batch axis (``len(slabs)``), each slab's own
        summary; merging is the caller's job — summaries are order-sensitive
        (``last2``).
        """
        if not slabs:
            raise ValueError("empty slab batch")
        check_stackable(slabs)
        norm = (region_mod.normalize_region(region, slabs[0].shape[1:])
                if region is not None else None)
        with trace.span("hsz.engine.stack"):
            stacked = batch_stack(list(slabs))
        return oplib.summarize_slab(stacked, Stage(stage), region=norm)

    @trace.spanned("hsz.engine.run")
    def merge_summaries(self, a: oplib.TemporalSummary,
                        b: oplib.TemporalSummary) -> oplib.TemporalSummary:
        """Pairwise summary merge, for every append and every fold step."""
        return oplib.merge_summaries(a, b)

    @trace.spanned("hsz.engine.run")
    def run_temporal(self, ops: str | Sequence[str],
                     summary: oplib.TemporalSummary, eps):
        """Temporal op postludes on one merged summary, whatever the number
        of slabs it merged."""
        names = oplib.canonical_ops(ops)
        if not oplib.is_temporal_ops(names):
            raise ValueError(f"{names} is not a temporal op set")
        return oplib.temporal_postlude(names, summary, eps)

    # -- expression DAGs ------------------------------------------------------
    @trace.spanned("hsz.engine.run")
    def run_expr(self, program, bindings: Sequence, stages: Sequence[Stage],
                 *, region=None, seeds: Sequence | None = None,
                 precomputed: Mapping[str, torch.Tensor] | None = None):
        """Execute one analyzed expression DAG in a single call.

        ``bindings`` holds one entry per leaf slot — a field, a component
        tuple, or ``None`` for temporal slots whose op values arrive through
        ``precomputed`` (keyed by canonical node serialization); ``stages``
        is the joint per-component plan
        (:class:`~repro_torch.analytics.planner.ExprPlan`); ``seeds``
        optionally store-seeds individual slots.
        """
        seeds = list(seeds) if seeds is not None else [None] * len(bindings)
        if len(seeds) != len(bindings):
            raise ValueError(f"{len(seeds)} seeds for {len(bindings)} slots")
        pre = dict(precomputed) if precomputed is not None else {}
        return expr_mod.lower(program, list(bindings),
                              tuple(Stage(s) for s in stages), region=region,
                              seeds=seeds, precomputed=pre)

    # -- stage resolution -----------------------------------------------------
    def _resolve(self, scheme, names: tuple[str, ...], stage: StageLike,
                 region, field, axis: int) -> StageSetPlan:
        """Plan only when asked to: a resolved Stage / StageSetPlan / per-op
        mapping from an upper layer is executed as-is (no double planning)."""
        if isinstance(stage, StageSetPlan):
            return stage
        if isinstance(stage, Stage):
            return StageSetPlan(names, tuple((op, stage) for op in names),
                                stage)
        if isinstance(stage, Mapping):
            stages = tuple((op, Stage(stage[op])) for op in names)
            resolved = {s for _, s in stages}
            fused = resolved.pop() if len(resolved) == 1 else None
            return StageSetPlan(names, stages, fused)
        return plan_stages(scheme, names, stage, self.cost_model,
                           region=region, field=field, axis=axis)

    # -- execution ------------------------------------------------------------
    @trace.spanned("hsz.engine.run")
    def run(self, fields: Sequence, ops: str | Sequence[str],
            stage: StageLike = "auto", *, axis: int = 0, region=None,
            seeds: Sequence | None = None):
        """Run an op (or fused op set) over ``fields`` in one batched call.

        ``fields`` is a sequence of same-layout :class:`Compressed` /
        :class:`Encoded` fields — or, for vector op sets
        (``divergence``/``curl``), a sequence of equal-length component
        tuples.  A single op name returns the batched result (leading axis =
        ``len(fields)``); an op *set* returns ``{op: batched result}`` from
        one call per fused plan (one call per op when the plan is unfused).
        ``curl`` in 3-D and ``gradient`` return a tuple of batched
        components, matching the unbatched ops.  ``region`` restricts every
        field to the same window (one static plan serves the batch).

        ``seeds`` optionally supplies one store-resident
        :class:`~repro_torch.store.MaterializedStage` per field (per
        component tuple for vector sets) matching the resolved fused stage:
        the call stacks them once and runs no stage reconstruction.
        Seeds require a fused plan (an unfused fallback re-plans per op at
        stages the seeds don't match).
        """
        single = isinstance(ops, str)
        names = oplib.canonical_ops(ops)
        if not fields:
            raise ValueError("empty batch")

        vector = oplib.is_vector_ops(names)
        if vector:
            n_comp = len(fields[0])
            if any(len(f) != n_comp for f in fields):
                raise ValueError("all vector fields must have the same number "
                                 "of components")
            first = fields[0][0]
            for i in range(n_comp):
                check_stackable([f[i] for f in fields])
        else:
            n_comp = 1
            first = fields[0]
            check_stackable(fields)
        d_axis = axis if any(oplib.OPS[n].needs_axis for n in names) else 0

        plan = self._resolve(first.scheme, names, stage, region, first, d_axis)
        if plan.fused is None:
            out = {op: self.run(fields, op, plan.stage_of(op),
                                axis=axis, region=region)
                   for op in names}
            return out[names[0]] if single else out

        if seeds is not None:
            if len(seeds) != len(fields):
                raise ValueError(
                    f"{len(seeds)} seeds for {len(fields)} fields")
            # per-component signatures may differ (per-axis band closures);
            # across the batch each component's seeds must agree
            per_comp = (tuple(zip(*seeds)) if vector else (tuple(seeds),))
            for comp_seeds in per_comp:
                sigs = {s.sig() for s in comp_seeds}
                if len(sigs) != 1:
                    raise ValueError(
                        f"seeds must share one layout signature per "
                        f"component, got {sigs}")
                # the seed owns the stage-serving rule (③ serves ④, ...)
                if not comp_seeds[0].serves(plan.fused):
                    raise ValueError(
                        f"seeds materialized at stage "
                        f"{Stage(comp_seeds[0].stage).name} cannot seed a "
                        f"stage-{plan.fused.name} plan")
        if region is not None:
            region = region_mod.normalize_region(region, first.shape)

        # one batched call: the fields (and their seeds) stacked once, each
        # kernel launched once for the batch
        with trace.span("hsz.engine.stack"):
            if vector:
                target = [batch_stack([f[k] for f in fields])
                          for k in range(n_comp)]
                seed = (None if seeds is None else
                        [stack_seeds([s[k] for s in seeds])
                         for k in range(n_comp)])
            else:
                target = batch_stack(list(fields))
                seed = None if seeds is None else stack_seeds(list(seeds))
        out = oplib.compute(target, names, plan.fused, axis=d_axis,
                            region=region, seed=seed)
        return out[names[0]] if single else out


#: process-wide engine used by the query front-end.
default_engine = BatchedAnalytics()
