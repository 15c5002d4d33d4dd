"""Stage planner: the paper's Table I feasibility matrix + cost-based choice.

``FEASIBILITY[(scheme, op)]`` lists the stages the operation is defined at,
cheapest first.  The matrix mirrors — and is pinned by tests to — the actual
raise/no-raise behavior of :mod:`repro_torch.core.homomorphic`:

* ``mean``: stage ① only for the HSZx (block-mean) family, ②③④ for all;
* ``std``: ②③④ (① carries no pointwise information);
* stencils (``derivative``/``laplacian``/``divergence``/``curl``): stage ②
  only for nd schemes (1-D partitioning destroys the spatial layout, §V-B),
  ③④ for all.

``plan_stage`` resolves ``stage="auto"`` to the cheapest feasible stage.  By
default "cheapest" is stage order (①<②<③<④ — monotone in decompression work,
which matches the paper's measurements); a :class:`CostModel` calibrated from
``benchmarks/run.py`` CSV output refines the choice with measured
microseconds per call.

``plan_stages`` plans an *op set* jointly: it picks one shared stage
minimizing the **total** cost over the feasible intersection, so a fused
query pays a single stage reconstruction for every op (DESIGN.md §6).  When
the intersection is empty — or a calibrated model says independent per-op
stages are strictly cheaper even without the shared-decode saving — it falls
back to per-op planning (``StageSetPlan.fused is None``).

Region queries change the plan twice over.  Feasibility: the stage-① mean is
only eps-exact over block-aligned windows, so unaligned regions drop ① from
the feasible set.  Cost: each stage's measured full-field cost scales by the
fraction of the field its region closure touches
(:func:`repro_torch.core.region.closure_fraction`) — per-stage closures
differ for Lorenzo schemes (stage-② derivative bands vs stage-③ prefix
hulls), so
``stage="auto"`` can genuinely pick a different stage for a 1% window than
for the full field.
"""
from __future__ import annotations
from collections.abc import Iterable, Mapping, Sequence, Set as AbstractSet

import dataclasses
import json
import os

from ..core import Scheme, Stage, UnsupportedStageError, oplib
from ..core import region as region_mod

#: planned operations, in the op registry's canonical order.
OPS: tuple[str, ...] = tuple(oplib.OPS)
#: temporal (time-axis) operations over appended streams (repro_torch.stream).
TEMPORAL: tuple[str, ...] = tuple(oplib.TEMPORAL_OPS)
#: ops that take a sequence of component fields instead of a single field
MULTIVARIATE = frozenset(
    name for name, spec in oplib.OPS.items() if spec.arity == "vector")


def _build_matrix() -> dict[tuple[Scheme, str], tuple[Stage, ...]]:
    """Table I as data, derived from the op registries' own feasibility rows
    (one source of truth: :data:`repro_torch.core.oplib.OPS` plus the
    temporal registry :data:`repro_torch.core.oplib.TEMPORAL_OPS`)."""
    return {(scheme, name): spec.feasible(scheme)
            for scheme in Scheme
            for name, spec in oplib._ALL_OPS.items()}


#: Table I: (scheme, op) -> stages the op is defined at, cheapest first.
FEASIBILITY: dict[tuple[Scheme, str], tuple[Stage, ...]] = _build_matrix()


def as_stage(stage: Stage | str | int) -> Stage:
    """Coerce ``Stage`` / int / name ("M", "p", ...) to a :class:`Stage`."""
    if isinstance(stage, str):
        try:
            return Stage[stage.upper()]
        except KeyError:
            raise ValueError(f"unknown stage {stage!r}; expected one of "
                             f"{[s.name for s in Stage]} or 'auto'") from None
    return Stage(stage)


def feasible_stages(scheme: Scheme, op: str) -> tuple[Stage, ...]:
    """Stages ``op`` is defined at for ``scheme``, cheapest first."""
    try:
        return FEASIBILITY[(Scheme(scheme), op)]
    except KeyError:
        spec = oplib._ALL_OPS.get(op)
        if spec is None:
            raise ValueError(
                f"unknown operation {op!r}; expected one of "
                f"{tuple(oplib._ALL_OPS)}") from None
        # registered after the matrix was derived (oplib.register_op):
        # resolve straight from the spec — same source of truth
        return spec.feasible(Scheme(scheme))


def is_feasible(scheme: Scheme, op: str, stage: Stage) -> bool:
    return Stage(stage) in feasible_stages(scheme, op)


def check_feasible(scheme: Scheme, op: str, stage: Stage) -> Stage:
    """Validate an explicit stage choice with the ops' own error semantics."""
    stage = as_stage(stage)
    if not is_feasible(scheme, op, stage):
        raise UnsupportedStageError(
            f"{op} is not defined at stage {stage.name} for scheme "
            f"{Scheme(scheme).value}; feasible stages: "
            f"{[s.name for s in feasible_stages(scheme, op)]}")
    return stage


def _resident_rank(cached: AbstractSet[Stage]):
    """Stage ranking when costs are unmeasured but residency is known:
    stages needing no reconstruction (cached, or ① — metadata is always
    resident in the container) beat stages that must reconstruct; ties go
    to stage order."""
    resident = set(cached) | {Stage.M}
    return lambda s: (0 if s in resident else 1, int(s))


class CostModel:
    """Per-``(scheme, op, stage)`` cost estimates in microseconds per call,
    plus per-``(scheme, stage)`` *reconstruction* costs used to price
    cache-resident stages.

    Uncalibrated cells fall back to a stage-ordered default (stage index
    scaled to rank *below* any measured cost is wrong — instead the default
    is only used when the whole ``(scheme, op)`` row is unmeasured, so mixed
    calibration never compares measured against made-up numbers).

    A *cached* stage (its materialized intermediate is resident in a
    :class:`repro_torch.store.FieldStore`) drops the reconstruction term: its
    effective cost is ``max(measured - reconstruction, 0)``, with the
    reconstruction calibrated from the ``fig34`` decompression rows.  An
    unmeasured reconstruction falls back to the largest one measured at a
    *lower* stage — reconstruction work is monotone in stage (paper §V),
    so the discount stays conservative and a cached stage never beats a
    measured rival on made-up numbers.
    """

    def __init__(self, table: dict[tuple[Scheme, str, Stage], float] | None = None,
                 recon: dict[tuple[Scheme, Stage], float] | None = None):
        self.table: dict[tuple[Scheme, str, Stage], float] = dict(table or {})
        self._counts: dict[tuple[Scheme, str, Stage], int] = {
            k: 1 for k in self.table}
        self.recon: dict[tuple[Scheme, Stage], float] = dict(recon or {})
        self._recon_counts: dict[tuple[Scheme, Stage], int] = {
            k: 1 for k in self.recon}

    # -- calibration -------------------------------------------------------
    _BENCH_OP_ALIASES = {"deriv": "derivative", "div": "divergence"}
    _BENCH_STAGE_TAGS = {"m": Stage.M, "p": Stage.P, "q": Stage.Q, "f": Stage.F}

    def record(self, scheme: Scheme, op: str, stage: Stage, us: float) -> None:
        key = (Scheme(scheme), op, Stage(stage))
        # true running mean over repeated observations (multiple datasets):
        # order-independent, every observation weighted equally
        n = self._counts.get(key, 0)
        prev = self.table.get(key, 0.0)
        self.table[key] = (prev * n + us) / (n + 1)
        self._counts[key] = n + 1

    def record_reconstruction(self, scheme: Scheme, stage: Stage, us: float) -> None:
        """Record a measured stage-reconstruction (decompression) cost."""
        key = (Scheme(scheme), Stage(stage))
        n = self._recon_counts.get(key, 0)
        prev = self.recon.get(key, 0.0)
        self.recon[key] = (prev * n + us) / (n + 1)
        self._recon_counts[key] = n + 1

    @classmethod
    def from_benchmark_csv(cls, rows: str | Iterable[str]) -> "CostModel":
        """Calibrate from ``benchmarks/run.py`` output.

        Parses the op-throughput rows (``fig58/…``, ``fig910/…``,
        ``fig1112/…``), whose names encode ``…/<op>/<scheme>-<stage_tag>``,
        and the per-stage decompression rows (``fig34/<ds>/<scheme>-<tag>``)
        into the reconstruction table; other rows are ignored.
        """
        model = cls()
        if isinstance(rows, str):
            rows = rows.splitlines()
        for line in rows:
            line = line.strip()
            if not line or line.startswith(("#", "name,")):
                continue
            name, _, rest = line.partition(",")
            us_text = rest.partition(",")[0]
            parts = name.split("/")
            if len(parts) == 3 and parts[0] == "fig34":
                scheme_name, _, tag = parts[2].rpartition("-")
                if tag not in cls._BENCH_STAGE_TAGS:
                    continue
                try:
                    model.record_reconstruction(Scheme(scheme_name),
                                                cls._BENCH_STAGE_TAGS[tag],
                                                float(us_text))
                except ValueError:
                    continue
                continue
            if len(parts) != 4 or parts[0] not in ("fig58", "fig910", "fig1112"):
                continue
            op = cls._BENCH_OP_ALIASES.get(parts[2], parts[2])
            scheme_name, _, tag = parts[3].rpartition("-")
            if op not in OPS or tag not in cls._BENCH_STAGE_TAGS:
                continue
            try:
                scheme = Scheme(scheme_name)
                us = float(us_text)
            except ValueError:
                continue
            model.record(scheme, op, cls._BENCH_STAGE_TAGS[tag], us)
        return model

    # -- persistence (satellite: calibrations must survive the process) ----
    _FORMAT = "hsz-cost-model"

    def save(self, path: str | os.PathLike) -> None:
        """JSON-serialize the full calibration state (cells, reconstruction
        table, observation counts) so CI and serving reuse measured models."""
        def skey(k):
            return (k[0].value,) + tuple(str(p) for p in k[1:])

        payload = {
            "format": self._FORMAT,
            "version": 1,
            "cells": [
                {"scheme": sch.value, "op": op, "stage": st.name,
                 "us": self.table[(sch, op, st)],
                 "count": self._counts.get((sch, op, st), 1)}
                for sch, op, st in sorted(self.table, key=skey)],
            "recon": [
                {"scheme": sch.value, "stage": st.name,
                 "us": self.recon[(sch, st)],
                 "count": self._recon_counts.get((sch, st), 1)}
                for sch, st in sorted(self.recon, key=skey)],
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")

    @classmethod
    def load(cls, path: str | os.PathLike) -> "CostModel":
        """Inverse of :meth:`save`: an exact round-trip, including the
        observation counts, so post-load :meth:`record` calls continue the
        same running means.

        Tolerates JSON written by older versions: entries missing required
        keys (stage, microseconds, ...) — and a missing reconstruction
        table entirely — are skipped with a warning, so the affected cells
        simply fall back to the uncalibrated planning path instead of the
        whole load dying with a ``KeyError``.
        """
        import warnings

        with open(path) as f:
            data = json.load(f)
        if data.get("format") != cls._FORMAT:
            raise ValueError(f"{path}: not a {cls._FORMAT} file")
        if data.get("version") != 1:
            raise ValueError(f"{path}: unsupported version {data.get('version')!r}")
        model = cls()
        skipped = 0
        for cell in data.get("cells", ()):
            try:
                key = (Scheme(cell["scheme"]), str(cell["op"]),
                       Stage[cell["stage"]])
                us = float(cell["us"])
            except (KeyError, ValueError, TypeError):
                skipped += 1
                continue
            model.table[key] = us
            model._counts[key] = int(cell.get("count", 1))
        for cell in data.get("recon", ()):
            try:
                key = (Scheme(cell["scheme"]), Stage[cell["stage"]])
                us = float(cell["us"])
            except (KeyError, ValueError, TypeError):
                skipped += 1
                continue
            model.recon[key] = us
            model._recon_counts[key] = int(cell.get("count", 1))
        if skipped:
            warnings.warn(
                f"{path}: skipped {skipped} malformed cost-model cell(s) "
                "(older save format?); the affected cells plan uncalibrated",
                stacklevel=2)
        return model

    # -- lookup ------------------------------------------------------------
    def reconstruction(self, scheme: Scheme, stage: Stage) -> float | None:
        """Measured reconstruction microseconds for a stage (① is free —
        metadata is always resident)."""
        if Stage(stage) == Stage.M:
            return 0.0
        return self.recon.get((Scheme(scheme), Stage(stage)))

    def cost(self, scheme: Scheme, op: str, stage: Stage, *,
             cached: bool = False) -> float | None:
        base = self.table.get((Scheme(scheme), op, Stage(stage)))
        if base is None or not cached:
            return base
        rec = self.reconstruction(scheme, stage)
        if rec is None:
            # monotone fallback: reconstruction work grows with stage
            # (paper §V), so the largest measurement at a lower stage
            # *under*-estimates this stage's — a conservative discount
            lower = [v for s in Stage if s < Stage(stage)
                     for v in [self.recon.get((Scheme(scheme), s))]
                     if v is not None]
            rec = max(lower) if lower else 0.0
        return max(base - rec, 0.0)

    def cheapest(self, scheme: Scheme, op: str, stages: Sequence[Stage],
                 fractions: Mapping[Stage, float] | None = None,
                 cached: AbstractSet[Stage] | None = None) -> Stage:
        """Cheapest stage; ``fractions`` scale each stage's measured cost by
        the share of the field its region closure touches (1.0 = full
        field); stages in ``cached`` are priced without their reconstruction
        term."""
        cached = frozenset(cached or ())
        costs = {s: self.cost(scheme, op, s, cached=s in cached)
                 for s in stages}
        if any(c is None for c in costs.values()):
            # incomplete row: fall back to stage order rather than mixing
            # measured numbers with fabricated defaults — but residency is
            # hard knowledge, so cached stages still rank first
            return min(stages, key=_resident_rank(cached))
        if fractions is not None:
            costs = {s: c * fractions.get(s, 1.0) for s, c in costs.items()}
        return min(stages, key=lambda s: (costs[s], int(s)))


def plan_stage(scheme: Scheme, op: str,
               stage: Stage | str | int = "auto",
               cost_model: CostModel | None = None, *,
               region=None, field=None, axis: int = 0,
               cached: AbstractSet[Stage] | None = None) -> Stage:
    """Resolve the execution stage for ``op`` on ``scheme``.

    ``stage="auto"`` picks the cheapest feasible stage (never one that would
    raise :class:`UnsupportedStageError`); an explicit stage is validated
    against the feasibility matrix.  With ``region`` (and the queried
    ``field`` for its geometry), stage ① is dropped/rejected for windows that
    are not block-aligned, and calibrated costs scale with each stage's
    region-closure size.  ``cached`` names the stages whose materialized
    intermediates are store-resident: their reconstruction term is dropped,
    so auto planning can pick a *higher* stage than it would cold.
    """
    cached = frozenset(cached or ())
    if stage != "auto":
        stage = check_feasible(scheme, op, stage)
        if (stage == Stage.M and region is not None and field is not None
                and not region_mod.region_aligned(field, region)):
            raise UnsupportedStageError(
                f"stage-1 {op} over a region needs a block-aligned window")
        return stage
    stages = feasible_stages(scheme, op)
    if region is not None and Stage.M in stages:
        aligned = (field is not None
                   and region_mod.region_aligned(field, region))
        if not aligned:
            stages = tuple(s for s in stages if s != Stage.M)
    if cost_model is not None:
        fractions = None
        if region is not None and field is not None:
            fractions = {s: region_mod.closure_fraction(field, op, s, region,
                                                        axis=axis)
                         for s in stages}
        return cost_model.cheapest(scheme, op, stages, fractions, cached)
    if cached:
        # no measured costs, but residency is hard knowledge: a resident
        # stage pays no reconstruction, which is the dominant term (§V)
        return min(stages, key=_resident_rank(cached))
    return stages[0]


@dataclasses.dataclass(frozen=True)
class StageSetPlan:
    """Resolved execution plan for one op set.

    ``fused`` is the single shared stage every op runs at (one stage
    reconstruction for the whole set), or ``None`` when the planner fell
    back to independent per-op stages; ``stages`` maps each op to its
    resolved stage either way.
    """

    ops: tuple[str, ...]
    stages: tuple[tuple[str, Stage], ...]
    fused: Stage | None

    def stage_of(self, op: str) -> Stage:
        return dict(self.stages)[op]

    @property
    def n_dispatches(self) -> int:
        """Program calls one engine dispatch of this plan issues."""
        return 1 if self.fused is not None else len(self.ops)


def _max_shard_fraction(field, op: str, stage: Stage, region, axis: int,
                        placement) -> float:
    """Sharded replacement for :func:`repro_torch.core.region
    .closure_fraction`: the *max* over participating shards of each shard's
    share of the stage's decode work — shards reconstruct their owned blocks
    concurrently, so the critical path is the busiest shard, never the sum.
    Stage ① touches metadata only (no payload decode), so it keeps the
    spatial fraction."""
    stage = Stage(stage)
    if stage == Stage.M:
        return (1.0 if region is None or field is None
                else region_mod.closure_fraction(field, op, stage, region,
                                                 axis=axis))
    if op in ("divergence", "curl"):
        nd = len(field.shape) if field is not None else 1
        fr = [_max_shard_fraction(field, "derivative", stage, region, a,
                                  placement) for a in range(nd)]
        return sum(fr) / len(fr)
    if region is None or field is None:
        return placement.max_fraction(None)
    closure = region_mod.op_closure(field.scheme, op, stage, axis)
    plan = region_mod.plan_region(field, region, closure)
    return placement.max_fraction(plan)


def plan_stages(scheme: Scheme, ops: str | Sequence[str],
                stage: Stage | str | int = "auto",
                cost_model: CostModel | None = None, *,
                region=None, field=None, axis: int = 0,
                cached: AbstractSet[Stage] | None = None,
                placement=None) -> StageSetPlan:
    """Jointly resolve the execution stage(s) for an op *set*.

    An explicit stage is validated against every op in the set.  With
    ``stage="auto"`` the planner picks the shared stage minimizing the
    *total* (region-closure-scaled) cost over the feasible intersection —
    fusing the set onto one stage reconstruction — and falls back to
    independent per-op stages only when the intersection is empty, or when a
    fully calibrated cost model prices the per-op optima strictly below the
    best shared stage (conservative: measured per-op costs each include
    their own decode, so this comparison understates the fusion saving).
    ``cached`` stages (store-resident materializations) are priced without
    their reconstruction term, which can flip the shared stage to a higher
    one that is already resident.

    ``placement`` (a :class:`repro_torch.shard.BlockPlacement`, duck-typed)
    turns on the sharded cost rule: each op's reconstruction cost scales by
    the **max** per-shard share of its closure instead of the whole-field
    (or region) fraction — participating shards decode concurrently
    (:func:`_max_shard_fraction`).  Only the calibrated totals change; the
    feasibility and residency logic is placement-blind.

    ``plan_stages(scheme, [op])`` always agrees with ``plan_stage``.
    """
    cached = frozenset(cached or ())
    names = oplib.canonical_ops(ops)
    if stage != "auto":
        resolved = as_stage(stage)
        for op in names:
            check_feasible(scheme, op, resolved)
        if (resolved == Stage.M and region is not None and field is not None
                and not region_mod.region_aligned(field, region)):
            raise UnsupportedStageError(
                f"stage-1 {names[0]} over a region needs a block-aligned window")
        return StageSetPlan(names, tuple((op, resolved) for op in names),
                            resolved)

    feas: dict[str, tuple[Stage, ...]] = {}
    for op in names:
        stages = feasible_stages(scheme, op)
        if region is not None and Stage.M in stages:
            aligned = (field is not None
                       and region_mod.region_aligned(field, region))
            if not aligned:
                stages = tuple(s for s in stages if s != Stage.M)
        feas[op] = stages

    def per_op_plan() -> tuple[tuple[str, Stage], ...]:
        return tuple(
            (op, plan_stage(scheme, op, "auto", cost_model,
                            region=region, field=field, axis=axis,
                            cached=cached))
            for op in names)

    inter = tuple(s for s in Stage if all(s in f for f in feas.values()))
    if not inter:
        return StageSetPlan(names, per_op_plan(), None)

    # residency only ever discounts stages the candidate can actually run
    # at: for the *shared* choice that is the feasible intersection, so a
    # cached stage outside it (e.g. a resident stage-② materialization
    # under a gradient-bearing set on a 1-D scheme) is neither priced nor
    # raises — the shared stage falls back to cold planning over the
    # remaining feasible stages, while per-op fallbacks keep their own
    # (per-op-feasible) residency discounts
    shared_cached = cached & frozenset(inter)

    calibrated = cost_model is not None and all(
        cost_model.cost(scheme, op, s) is not None
        for op in names for s in feas[op])
    if calibrated:
        fractions: dict[tuple[str, Stage], float] = {}

        def cost(op: str, s: Stage) -> float:
            key = (op, s)
            if key not in fractions:
                if placement is not None:
                    fractions[key] = _max_shard_fraction(
                        field, op, s, region, axis, placement)
                else:
                    fractions[key] = (
                        1.0 if region is None or field is None
                        else region_mod.closure_fraction(field, op, s, region,
                                                         axis=axis))
            return (cost_model.cost(scheme, op, s, cached=s in cached)
                    * fractions[key])

        totals = {s: sum(cost(op, s) for op in names) for s in inter}
        shared = min(inter, key=lambda s: (totals[s], int(s)))
        per_op = per_op_plan()
        per_total = sum(cost(op, s) for op, s in per_op)
        if per_total < totals[shared]:
            return StageSetPlan(names, per_op, None)
    elif shared_cached:
        # uncalibrated but residency is known: a resident shared stage pays
        # no reconstruction at all — prefer it over any cold stage
        shared = min(inter, key=_resident_rank(shared_cached))
    else:
        # stage order is monotone in decompression work (paper §V): the
        # lowest shared stage is the cheapest joint reconstruction
        shared = inter[0]
    return StageSetPlan(names, tuple((op, shared) for op in names), shared)


# ===========================================================================
# expression DAGs: joint stage planning per connected component
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class ExprPlan:
    """Resolved joint stages for an analyzed expression DAG
    (``repro_torch.core.expr.ExprProgram``): one :class:`Stage` per connected
    component, indexed by the program's ``leaf_component`` /
    ``root_component`` maps.  The whole DAG lowers into a single cached
    program, so the plan itself contributes one dispatch."""

    stages: tuple[Stage, ...]


def plan_expr(program, bindings: Sequence, stage="auto",
              cost_model: CostModel | None = None, *, region=None,
              cached: Sequence[AbstractSet[Stage]] | None = None) -> ExprPlan:
    """Jointly plan the execution stage of each DAG component.

    Every ``(op application, leaf scheme)`` pair in a component contributes
    its feasible-stage row; the component runs at one stage from the
    intersection (never empty — stages ③④ are universally feasible), so all
    preludes a combinator joins are stage-compatible.  An explicit ``stage``
    is validated against every pair (op error semantics preserved).  With
    ``stage="auto"``: a fully calibrated cost model minimizes the total
    (region-closure-scaled, residency-discounted) cost; otherwise stages at
    which *every* leaf of the component is store-resident (``cached``, per
    leaf slot) rank first, falling back to stage order.  An unaligned
    ``region`` drops stage ① exactly as in :func:`plan_stages`.
    """
    cached = (list(cached) if cached is not None
              else [frozenset()] * len(bindings))

    def slot_field(slot: int):
        b = bindings[slot]
        return b[0] if isinstance(b, tuple) else b

    out = []
    for comp in range(program.n_components):
        pairs = []  # (op name, scheme, leaf slot, axis)
        for name, axis, slot in program.component_ops(comp):
            b = bindings[slot]
            schemes = ([c.scheme for c in b] if isinstance(b, tuple)
                       else [b.scheme])
            pairs.extend((name, sch, slot, axis) for sch in schemes)
        if stage != "auto":
            resolved = as_stage(stage)
            for name, sch, slot, _axis in pairs:
                check_feasible(sch, name, resolved)
                if (resolved == Stage.M and region is not None
                        and not region_mod.region_aligned(slot_field(slot),
                                                          region)):
                    raise UnsupportedStageError(
                        f"stage-1 {name} over a region needs a "
                        "block-aligned window")
            out.append(resolved)
            continue

        feas_sets = []
        for name, sch, slot, _axis in pairs:
            stages = feasible_stages(sch, name)
            if region is not None and Stage.M in stages:
                if not region_mod.region_aligned(slot_field(slot), region):
                    stages = tuple(s for s in stages if s != Stage.M)
            feas_sets.append(stages)
        inter = tuple(s for s in Stage if all(s in f for f in feas_sets))

        comp_slots = sorted({slot for _, _, slot, _ in pairs})
        resident = frozenset(
            s for s in inter
            if all(s in cached[sl] for sl in comp_slots))
        calibrated = cost_model is not None and all(
            cost_model.cost(sch, name, s) is not None
            for name, sch, slot, axis in pairs for s in inter)
        if calibrated:
            def pair_cost(name, sch, slot, axis, s):
                frac = 1.0
                if region is not None:
                    frac = region_mod.closure_fraction(
                        slot_field(slot), name, s, region, axis=axis)
                return cost_model.cost(sch, name, s,
                                       cached=s in cached[slot]) * frac

            totals = {s: sum(pair_cost(*p, s) for p in pairs) for s in inter}
            out.append(min(inter, key=lambda s: (totals[s], int(s))))
        elif resident:
            out.append(min(inter, key=_resident_rank(resident)))
        else:
            out.append(inter[0])
    return ExprPlan(tuple(out))


# ===========================================================================
# streaming appends: incremental-update vs full-recompute costing
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class RefreshPlan:
    """How to bring a temporal field's resident summary up to date after an
    append (``repro_torch.stream``, DESIGN.md §9).

    ``mode`` is ``"incremental"`` (reconstruct only the appended slab and
    merge it into the resident summary) or ``"recompute"`` (reconstruct
    every slab — the only option when no summary is resident).  The costs
    are reconstruction microseconds from the calibrated fig3/4 table
    (``None`` when uncalibrated: the decision then rests on slab counts
    alone, which is exact — merge work is O(extent), reconstruction is the
    whole cost).
    """

    mode: str                            # "incremental" | "recompute"
    incremental_us: float | None      # one-slab reconstruction cost
    recompute_us: float | None        # all-slab reconstruction cost


def plan_refresh(scheme: Scheme, stage: Stage, n_slabs: int,
                 cost_model: CostModel | None = None, *,
                 summary_resident: bool = True) -> RefreshPlan:
    """Cost an append's summary refresh: incremental merge vs full rebuild.

    Incremental pays one slab's stage reconstruction; a recompute pays
    ``n_slabs`` of them.  With a resident summary the incremental path is
    never dearer (reconstruction cost is nonnegative and the integer merge
    is exact, so there is no accuracy argument for recomputing); without
    one there is nothing to merge into and the plan is a recompute — which
    the store then defers to the next query rather than paying eagerly.
    """
    if n_slabs < 1:
        raise ValueError(f"n_slabs must be >= 1, got {n_slabs}")
    rec = (cost_model.reconstruction(scheme, Stage(stage))
           if cost_model is not None else None)
    inc = rec
    full = rec * n_slabs if rec is not None else None
    if not summary_resident:
        return RefreshPlan("recompute", inc, full)
    return RefreshPlan("incremental", inc, full)
