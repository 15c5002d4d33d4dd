"""Batch executor: one cached program per op set over same-layout fields.

Many timesteps/variables of a scientific dataset share one compression
layout, so their homomorphic analytics run as *one program* over the batch
instead of one planning-and-dispatch round per field.  A program here is a
Python callable built once per key and kept in an LRU cache: calling it runs
:func:`repro_torch.core.oplib.compute` for each field of the batch on the
fields' device (one shared stage-reconstruction prelude per field; the fused
kernel rules wherever they cover) and stacks each result leaf along a new
leading axis — tuples per component, dicts per op.  Nothing in it waits for
the device: no ``.item()``, no copy to the host, so every field's kernels
queue back to back on the current stream.  Each band kernel is launched
once per field; a batch axis inside the kernels is the open counterpart of
the reference's ``vmap`` grid dimension.

Op *sets* fuse: ``run(fields, ["mean", "std", "laplacian"])`` shares one
decode per field across every postlude.  The cache key is the reference's
``(layout, frozen op set, stage, axis, components, bucketed batch, region,
seed signature, kernel mode)``, so the number of cached programs follows the
reference's for the same query sequence; the op-set component is
canonically ordered, so ``["std", "mean"]`` and ``["mean", "std"]`` hit the
same entry.  Store-seeded programs (``run(..., seeds=)``) take the fields'
materialized intermediates and run no stage reconstruction; they are cached
separately from their cold twins.

Streams (``repro_torch.stream``) run three more programs through the same
cache, under the reference's keys: the per-slab summarizer
(:meth:`BatchedAnalytics.summarize`), the pairwise merge
(:meth:`BatchedAnalytics.merge_summaries`) and the temporal op-set postlude
(:meth:`BatchedAnalytics.run_temporal`), keyed on slab layout and summary
signature but never on how many slabs a stream holds, so the cache does not
grow as a stream does.

Stage resolution is layered, not repeated: the engine plans only when given
``stage="auto"`` (or another directive string).  A resolved :class:`Stage`
or :class:`StageSetPlan` — e.g. from :func:`repro_torch.analytics.query.
query`, which already planned the group — is executed as-is; infeasible
explicit stages raise from the ops themselves.
"""
from __future__ import annotations

import functools
from collections import OrderedDict
from collections.abc import Callable, Mapping, Sequence

import torch

from ..core import Compressed, Encoded, Stage, layout_key, oplib
from ..core import expr as expr_mod
from ..core import region as region_mod
from .planner import CostModel, StageSetPlan, plan_stages

Field = Compressed | Encoded

StageLike = Stage | str | int | StageSetPlan | Mapping[str, Stage]


def batch_key(first: Field, ops: str | Sequence[str], stage: Stage,
              axis: int = 0, n_components: int = 1, batch: int = 1,
              region=None, seed_sig: tuple | None = None) -> tuple:
    """Static signature of one cached batched-analytics program.

    The (bucketed) batch size and the normalized region are part of the
    key, as are the canonically ordered op set, ``seed_sig``
    (:meth:`repro_torch.store.MaterializedStage.sig`: seeded programs run
    no reconstruction) and the kernel mode (:func:`repro_torch.core.oplib.
    kernel_sig`): the key is order-insensitive in the op set.
    """
    if region is not None:
        region = region_mod.normalize_region(region, first.shape)
    names = oplib.canonical_ops(ops)
    return layout_key(first) + (names, Stage(stage), axis, n_components,
                                batch, region, seed_sig, oplib.kernel_sig())


def _check_batch(fields: Sequence[Field]) -> None:
    """One layout and one device across a batch (the reference's
    ``batch_stack`` rule, with its message; the port stacks results, not
    inputs, so the check stands alone)."""
    key0, dev0 = layout_key(fields[0]), fields[0].eps.device
    for i, f in enumerate(fields[1:], 1):
        if layout_key(f) != key0:
            raise ValueError(
                f"cannot stack fields with different layouts: field 0 has "
                f"{key0}, field {i} has {layout_key(f)}")
        if f.eps.device != dev0:
            raise ValueError(
                f"cannot stack fields on different devices: field 0 lies on "
                f"{dev0}, field {i} on {f.eps.device}")


def _stack(outs: list):
    """Stack per-field results along a new leading axis, leaf by leaf."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack(list(parts)) for parts in zip(*outs))
    return torch.stack(outs)


class BatchedAnalytics:
    """Executes one homomorphic op set over a batch of same-layout fields.

    One instance owns one program cache; module-level :data:`default_engine`
    is shared by :func:`repro_torch.analytics.query.query`.

    Each batch length is rounded up to the next power of two *in the key*
    (the reference pads the batch with repeats of the last field and slices
    their results off; the port computes no repeats), so a queue of
    fluctuating depth caches O(log max_batch) programs per op set, as the
    reference's does.  The cache is LRU-bounded by ``cache_limit``.
    """

    def __init__(self, cost_model: CostModel | None = None, *,
                 cache_limit: int = 128):
        self.cost_model = cost_model
        self.cache_limit = cache_limit
        self._programs: OrderedDict[tuple, Callable] = OrderedDict()

    @staticmethod
    def _bucket(n: int) -> int:
        return 1 << (n - 1).bit_length()

    # -- program cache --------------------------------------------------------
    @property
    def cache_size(self) -> int:
        return len(self._programs)

    def _call(self, key: tuple, build: Callable[[], Callable], *args):
        """Run the program of ``key`` on ``args``: a hit refreshes its LRU
        place, a miss builds it and evicts from the LRU end."""
        fn = self._programs.get(key)
        fresh = fn is None
        if fresh:
            fn = build()
            self._programs[key] = fn
            while len(self._programs) > self.cache_limit:
                self._programs.popitem(last=False)
        else:
            self._programs.move_to_end(key)
        try:
            return fn(*args)
        except Exception:
            # an infeasible explicit stage raises on the first call; don't
            # keep a program that always raises (warm entries stay)
            if fresh:
                self._programs.pop(key, None)
            raise

    # -- temporal (streaming) programs ---------------------------------------
    def summarize(self, slabs: Sequence[Field], stage: Stage, *,
                  region=None) -> oplib.TemporalSummary:
        """Per-slab temporal summaries of same-layout slabs: one cached
        program per ``(slab layout, stage, region, bucketed batch)``.

        The key never includes the stream's total slab count or the slab
        index, so every append of a same-layout slab reuses the same program
        (``repro_torch.stream``, DESIGN.md §9).  Returns a
        :class:`~repro_torch.core.oplib.TemporalSummary` whose leaves carry a
        leading batch axis (``len(slabs)``), the per-slab summaries stacked;
        merging is the caller's job — summaries are order-sensitive
        (``last2``).
        """
        if not slabs:
            raise ValueError("empty slab batch")
        _check_batch(slabs)
        first = slabs[0]
        stage = Stage(stage)
        norm = (region_mod.normalize_region(region, first.shape[1:])
                if region is not None else None)
        key = layout_key(first) + ("__temporal_summary__", stage, norm,
                                   self._bucket(len(slabs)),
                                   oplib.kernel_sig())

        def build():
            def run(items):
                parts = [oplib.summarize_slab(c, stage, region=norm)
                         for c in items]
                return oplib.map_summaries(lambda *xs: torch.stack(xs),
                                           *parts)
            return run

        return self._call(key, build, list(slabs))

    def merge_summaries(self, a: oplib.TemporalSummary,
                        b: oplib.TemporalSummary) -> oplib.TemporalSummary:
        """Pairwise summary merge: one program per summary signature, reused
        for every append and every fold step."""
        key = ("__temporal_merge__", a.sig(), b.sig())
        return self._call(key, lambda: oplib.merge_summaries, a, b)

    def run_temporal(self, ops: str | Sequence[str],
                     summary: oplib.TemporalSummary, eps):
        """Temporal op postludes on one merged summary: one program per
        (canonical op set, summary signature), independent of how many
        slabs the summary merged."""
        names = oplib.canonical_ops(ops)
        if not oplib.is_temporal_ops(names):
            raise ValueError(f"{names} is not a temporal op set")
        key = ("__temporal_post__", names, summary.sig())

        def build():
            return functools.partial(oplib.temporal_postlude, names)

        return self._call(key, build, summary, eps)

    # -- expression DAGs ------------------------------------------------------
    def run_expr(self, program, bindings: Sequence, stages: Sequence[Stage],
                 *, region=None, seeds: Sequence | None = None,
                 precomputed: Mapping[str, torch.Tensor] | None = None):
        """Execute one analyzed expression DAG as a single cached program.

        ``bindings`` holds one entry per leaf slot — a field, a component
        tuple, or ``None`` for temporal slots whose op values arrive through
        ``precomputed`` (keyed by canonical node serialization); ``stages``
        is the joint per-component plan
        (:class:`~repro_torch.analytics.planner.ExprPlan`); ``seeds``
        optionally store-seeds individual slots.  The key is the program's
        structural hash plus every static input signature, so two
        structurally identical DAGs over same-layout fields share one
        program whichever tensors they bind.
        """
        precomputed = dict(precomputed or {})
        seeds = list(seeds) if seeds is not None else [None] * len(bindings)
        if len(seeds) != len(bindings):
            raise ValueError(f"{len(seeds)} seeds for {len(bindings)} slots")

        def slot_layout(b):
            if b is None:
                return None
            if isinstance(b, tuple):
                return tuple(layout_key(c) for c in b)
            return layout_key(b)

        def slot_region(b):
            if b is None or region is None:
                return None
            f = b[0] if isinstance(b, tuple) else b
            return region_mod.normalize_region(region, f.shape)

        def slot_seed_sig(s):
            if s is None:
                return None
            if isinstance(s, tuple):
                return tuple(x.sig() for x in s)
            return s.sig()

        stages = tuple(Stage(s) for s in stages)
        pre_sig = tuple((k, tuple(v.shape),
                         str(v.dtype).removeprefix("torch."))
                        for k, v in sorted(precomputed.items()))
        key = ("__expr__", program.key,
               tuple(slot_layout(b) for b in bindings), stages,
               tuple(slot_region(b) for b in bindings),
               tuple(slot_seed_sig(s) for s in seeds), pre_sig,
               oplib.kernel_sig())

        def build():
            # the program takes the analyzed DAG as an argument rather than
            # holding it: a cached program must not pin the fields of the
            # query that built it
            def run(prog, binds, sds, pre):
                return expr_mod.lower(prog, binds, stages, region=region,
                                      seeds=sds, precomputed=pre)
            return run

        return self._call(key, build, program, list(bindings), seeds,
                          precomputed)

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
    def run(self, fields: Sequence, ops: str | Sequence[str],
            stage: StageLike = "auto", *, axis: int = 0, region=None,
            seeds: Sequence | None = None):
        """Run an op (or fused op set) over ``fields`` in one cached program.

        ``fields`` is a sequence of same-layout :class:`Compressed` /
        :class:`Encoded` fields — or, for vector op sets
        (``divergence``/``curl``), a sequence of equal-length component
        tuples.  A single op name returns the batched result (leading axis =
        ``len(fields)``); an op *set* returns ``{op: batched result}`` from
        one program per fused plan (one program per op when the plan is
        unfused).  ``curl`` in 3-D and ``gradient`` return a tuple of batched
        components, matching the unbatched ops.  ``region`` restricts every
        field to the same window.

        ``seeds`` optionally supplies one store-resident
        :class:`~repro_torch.store.MaterializedStage` per field (per
        component tuple for vector sets) matching the resolved fused stage:
        the program then runs no stage reconstruction.  Seeds require a
        fused plan (an unfused fallback re-plans per op at stages the seeds
        don't match).
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
                _check_batch([f[i] for f in fields])
        else:
            n_comp = 1
            first = fields[0]
            _check_batch(fields)
        d_axis = axis if any(oplib.OPS[n].needs_axis for n in names) else 0

        plan = self._resolve(first.scheme, names, stage, region, first, d_axis)
        if plan.fused is None:
            out = {op: self.run(fields, op, plan.stage_of(op),
                                axis=axis, region=region)
                   for op in names}
            return out[names[0]] if single else out

        seed_sig = None
        if seeds is not None:
            if len(seeds) != len(fields):
                raise ValueError(
                    f"{len(seeds)} seeds for {len(fields)} fields")
            # per-component signatures may differ (per-axis band closures);
            # across the batch each component's seeds must agree
            per_comp = (tuple(zip(*seeds)) if vector else (tuple(seeds),))
            comp_sigs = []
            for comp_seeds in per_comp:
                sigs = {s.sig() for s in comp_seeds}
                if len(sigs) != 1:
                    raise ValueError(
                        f"seeds must share one layout signature per "
                        f"component, got {sigs}")
                comp_sigs.append(sigs.pop())
                # the seed owns the stage-serving rule (③ serves ④, ...)
                if not comp_seeds[0].serves(plan.fused):
                    raise ValueError(
                        f"seeds materialized at stage "
                        f"{Stage(comp_seeds[0].stage).name} cannot seed a "
                        f"stage-{plan.fused.name} plan")
            seed_sig = tuple(comp_sigs)

        key = batch_key(first, names, plan.fused, d_axis, n_comp,
                        self._bucket(len(fields)), region, seed_sig)
        fused = plan.fused

        def build():
            def run(items, item_seeds):
                outs = []
                for i, item in enumerate(items):
                    seed = None if item_seeds is None else item_seeds[i]
                    outs.append(oplib.compute(
                        list(item) if vector else item, names, fused,
                        axis=d_axis, region=region, seed=seed))
                return _stack(outs)
            return run

        out = self._call(key, build, list(fields),
                         list(seeds) if seeds is not None else None)
        return out[names[0]] if single else out


#: process-wide engine (shared program cache) used by the query front-end.
default_engine = BatchedAnalytics()
