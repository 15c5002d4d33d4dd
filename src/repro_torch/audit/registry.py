"""Analyzer (1): registry / Table-I completeness.

The operator registry (`repro_torch.core.oplib`) is the single declarative source
the planner's Table-I feasibility matrix, the fused engine, region closures,
and the store's materialization keys all derive from.  Fused kernel rules
and sharded stores each add lowering rules per ``(stage, scheme-family)``
cell, so this pass statically proves the registry can't drift:

* every :class:`~repro_torch.core.oplib.OpSpec`'s feasible cell has **exactly
  one** lowering rule (a family rule next to an ``"any"`` rule would
  silently shadow it in ``compute``; a missing rule raises ``KeyError`` at
  query time, far from the declaration that caused it);
* region closures exist and are well-formed for every region-capable cell;
* the ``OPS`` / ``TEMPORAL_OPS`` registries merge collision-free and the
  merged view (``_ALL_OPS`` + canonical order) has not drifted;
* the planner's derived Table-I matrix agrees with the specs' own
  feasibility rows, for built-ins and user-registered ops alike.

All checks are *semantic* — they run against the live registries, so they
see exactly what ``compute`` will dispatch on, including ops added through
``oplib.register_op``.
"""
from __future__ import annotations

from collections.abc import Mapping

from ..core import oplib
from ..core.oplib import OpSpec
from ..core.stages import Scheme

from .findings import Finding

_ANALYZER = "registry"


def _spec_findings(name: str, spec: OpSpec) -> list[Finding]:
    out = []
    if spec.name != name:
        out.append(Finding(
            _ANALYZER, "registry-drift",
            f"registered under {name!r} but spec.name is {spec.name!r}",
            subject=name,
            suggestion="register specs under their own name"))
    for invariant, message in oplib.spec_violations(spec):
        out.append(Finding(
            _ANALYZER, invariant, message, subject=spec.name,
            suggestion="declare exactly one lowering rule per feasible "
                       "(stage, scheme-family) cell and a closure per "
                       "region-capable cell"))
    return out


def _merge_findings(ops: Mapping[str, OpSpec],
                    temporal: Mapping[str, OpSpec]) -> list[Finding]:
    out = []
    collisions = set(ops) & set(temporal)
    for name in sorted(collisions):
        out.append(Finding(
            _ANALYZER, "registry-collision",
            f"op {name!r} is registered in both OPS and TEMPORAL_OPS",
            subject=name,
            suggestion="op names must be unique across registries "
                       "(oplib._merge_registries rejects this at import)"))
    return out


def _drift_findings(ops: Mapping[str, OpSpec],
                    temporal: Mapping[str, OpSpec]) -> list[Finding]:
    """The merged lookup and canonical order must cover exactly the union
    of the two registries — ``register_op`` keeps them in sync; anything
    else desynchronizes canonical op-set order from planning."""
    out = []
    union = dict(ops)
    union.update(temporal)
    merged = set(oplib._ALL_OPS)
    for name in sorted(set(union) - merged):
        out.append(Finding(
            _ANALYZER, "registry-drift",
            f"op {name!r} is in a source registry but not in the merged "
            "_ALL_OPS lookup", subject=name,
            suggestion="register ops through oplib.register_op"))
    for name in sorted(merged - set(union)):
        out.append(Finding(
            _ANALYZER, "registry-drift",
            f"op {name!r} is in the merged _ALL_OPS lookup but in neither "
            "source registry", subject=name,
            suggestion="register ops through oplib.register_op"))
    for name in merged & set(union):
        if oplib._ALL_OPS[name] is not union[name]:
            out.append(Finding(
                _ANALYZER, "registry-drift",
                f"op {name!r}: merged lookup holds a different spec object "
                "than its source registry", subject=name,
                suggestion="never rebind registry entries in place"))
    missing_order = sorted(merged - set(oplib._ORDER))
    for name in missing_order:
        out.append(Finding(
            _ANALYZER, "registry-drift",
            f"op {name!r} has no canonical-order rank "
            "(canonical op-set ordering would KeyError)",
            subject=name,
            suggestion="register ops through oplib.register_op"))
    return out


def _matrix_findings(ops: Mapping[str, OpSpec],
                     temporal: Mapping[str, OpSpec]) -> list[Finding]:
    """The planner's derived Table-I matrix must agree with the specs."""
    from ..analytics import planner

    out = []
    union = dict(ops)
    union.update(temporal)
    for name, spec in union.items():
        for scheme in Scheme:
            declared = tuple(spec.feasible(scheme))
            derived = planner.feasible_stages(scheme, name)
            if tuple(derived) != declared:
                out.append(Finding(
                    _ANALYZER, "matrix-mismatch",
                    f"Table-I row for ({scheme.value}, {name}) is "
                    f"{tuple(s.name for s in derived)} but the spec "
                    f"declares {tuple(s.name for s in declared)}",
                    subject=name,
                    suggestion="planner.FEASIBILITY must derive from the "
                               "registry, never be edited by hand"))
    known = set(union)
    for (scheme, name) in planner.FEASIBILITY:
        if name not in known:
            out.append(Finding(
                _ANALYZER, "stale-matrix-row",
                f"Table-I matrix has a row for unknown op "
                f"({scheme.value}, {name})", subject=name,
                suggestion="drop rows for unregistered ops"))
    return out


def analyze_registry(ops: Mapping[str, OpSpec] | None = None,
                     temporal: Mapping[str, OpSpec] | None = None, *,
                     check_matrix: bool = True) -> list[Finding]:
    """Run the full registry-completeness pass.

    ``ops`` / ``temporal`` default to the live registries; tests pass
    synthetic registries with known-bad specs.  ``check_matrix=False``
    skips the planner cross-check (synthetic registries have no derived
    matrix to compare against).
    """
    ops = oplib.OPS if ops is None else ops
    temporal = oplib.TEMPORAL_OPS if temporal is None else temporal
    live = ops is oplib.OPS and temporal is oplib.TEMPORAL_OPS

    findings: list[Finding] = []
    for name, spec in ops.items():
        findings.extend(_spec_findings(name, spec))
        if spec.arity == "temporal":
            findings.append(Finding(
                _ANALYZER, "registry-drift",
                f"temporal-arity op {name!r} lives in the spatial OPS "
                "registry", subject=name,
                suggestion="register temporal ops in TEMPORAL_OPS"))
    for name, spec in temporal.items():
        findings.extend(_spec_findings(name, spec))
        if spec.arity != "temporal":
            findings.append(Finding(
                _ANALYZER, "registry-drift",
                f"{spec.arity}-arity op {name!r} lives in the temporal "
                "registry", subject=name,
                suggestion="register spatial ops in OPS"))
    findings.extend(_merge_findings(ops, temporal))
    if live:
        findings.extend(_drift_findings(ops, temporal))
    if check_matrix and live:
        findings.extend(_matrix_findings(ops, temporal))
    return findings
