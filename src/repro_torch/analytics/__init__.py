"""Batched homomorphic analytics: automatic stage planning + batched execution.

The paper's Table I says *which* decompression stage each analytical
operation can run at; its §V timings say stage choice is where the speedups
live.  This package turns that into an engine:

* :mod:`repro_torch.analytics.planner` — the feasibility matrix as data
  (derived from the declarative op registry in
  :mod:`repro_torch.core.oplib`), plus a cost model (optionally calibrated
  from ``benchmarks/run.py`` CSV) that picks the cheapest feasible stage —
  jointly over an op *set* via ``plan_stages``;
* :mod:`repro_torch.analytics.engine` — runs one op set over a batch of
  same-layout compressed fields as one cached program keyed like the
  reference's compilation cache;
* :mod:`repro_torch.analytics.query` — ``query(exprs=[...], store=...)``:
  the expression front-end.  Roots are :mod:`repro_torch.core.expr` DAGs
  (cross-field derived operators — vorticity from u and v, ensemble
  deltas); the whole batch runs as one program with exactly one
  stage-reconstruction prelude per distinct leaf, planned jointly per
  connected component (``plan_expr``).  With ``store=`` (a
  :class:`repro_torch.store.FieldStore`) leaves may be string ids, planning
  is cache-aware, and the program is seeded from resident materialized
  stages.  The flat op-set spelling ``query(fields, op_or_ops)`` remains as
  a deprecated bit-identical shim.

Temporal op sets (``TEMPORAL``: ``tdelta`` / ``tmean`` / ``tmin`` /
``tmax`` / ``tstd``) run through the same ``query()`` over appended
streams (:mod:`repro_torch.stream`).
"""
from .engine import BatchedAnalytics, batch_key
from .planner import (FEASIBILITY, MULTIVARIATE, OPS, TEMPORAL, CostModel,
                      ExprPlan, RefreshPlan, StageSetPlan, as_stage,
                      check_feasible, feasible_stages, is_feasible,
                      plan_expr, plan_refresh, plan_stage, plan_stages)
from .query import QueryResult, query

__all__ = [
    "OPS", "TEMPORAL", "MULTIVARIATE", "FEASIBILITY", "as_stage",
    "feasible_stages", "is_feasible", "check_feasible", "plan_stage",
    "plan_stages", "StageSetPlan", "plan_expr", "ExprPlan", "plan_refresh",
    "RefreshPlan", "CostModel", "BatchedAnalytics", "batch_key",
    "QueryResult", "query",
]
