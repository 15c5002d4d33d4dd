"""Materialized stage reconstructions (the seeds of ``compute(..., seed=)``).

:class:`MaterializedStage` / :func:`materialize` hold one ``(field, stage,
region, closure)`` intermediate — the stage-② residual sub-field or the
stage-③ integers — on the field's device; ``materialized_nbytes`` predicts
its size from the plan alone.  The byte-budgeted ``FieldStore`` that keeps
and evicts them is a later slice of the port.
"""
from .materialized import (MaterializedStage, materialize,
                           materialized_nbytes, serves, storage_stage)

__all__ = ["MaterializedStage", "materialize", "materialized_nbytes",
           "serves", "storage_stage"]
