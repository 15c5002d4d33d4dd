"""Audit runner + CLI: ``python -m repro_torch.audit [--json AUDIT.json]``.

Runs the five analyzers (registry completeness, int-width bounds, the
host-sync lint of the query path, CUDA launch-grid verification,
shard-partition exactness), prints findings,
writes the machine-readable report (findings + safe-size tables) when asked,
and exits non-zero iff there is at least one **error** finding — warnings
(stale waivers) print but never fail the run.  It imports neither jax nor
the reference package, so it runs on a machine that has neither.
"""
from __future__ import annotations

import argparse
import json
import sys

from .findings import AuditReport
from .intwidth import DEFAULT_ENVELOPE, Envelope, analyze_int_width, safe_size_table
from .kernelspec import analyze_kernel_specs
from .registry import analyze_registry
from .sharddisjoint import analyze_shard_disjoint, shard_safe_size_table
from .tracesafety import analyze_trace_safety

#: the reference's analyzers less ``jitkey``: the port has no program cache.
ALL_ANALYZERS = ("registry", "intwidth", "trace", "kernelspec",
                 "sharddisjoint")


def run_audit(env: Envelope = DEFAULT_ENVELOPE, *,
              analyzers: tuple = ALL_ANALYZERS) -> AuditReport:
    """Run the selected analyzers against the live repo; returns the full
    report (the safe-size tables are attached even when their analyzers
    are clean)."""
    report = AuditReport()
    if "registry" in analyzers:
        report.extend(analyze_registry())
    if "intwidth" in analyzers:
        report.extend(analyze_int_width(env))
        report.safe_sizes = safe_size_table(env)
    if "trace" in analyzers:
        report.extend(analyze_trace_safety())
    if "kernelspec" in analyzers:
        report.extend(analyze_kernel_specs(env))
    if "sharddisjoint" in analyzers:
        report.extend(analyze_shard_disjoint(env))
        report.shard_safe_sizes = shard_safe_size_table(env)
    return report


def _parse_only(value: str) -> tuple:
    names = tuple(n.strip() for n in value.split(",") if n.strip())
    bad = [n for n in names if n not in ALL_ANALYZERS]
    if bad or not names:
        raise argparse.ArgumentTypeError(
            f"unknown analyzer(s) {bad or [value]}; "
            f"choose from {', '.join(ALL_ANALYZERS)}")
    return names


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.audit",
        description="Static invariant audit of the PyTorch / CUDA port of "
                    "the homomorphic pipeline.")
    parser.add_argument("--json", metavar="PATH", default=None,
                        help="write the full machine-readable report "
                             "(findings + safe-size tables)")
    parser.add_argument("--only", metavar="A[,B]", type=_parse_only,
                        default=None,
                        help="comma-separated analyzer selection "
                             f"({', '.join(ALL_ANALYZERS)}); default: all")
    parser.add_argument("--analyzer", action="append", default=None,
                        choices=list(ALL_ANALYZERS),
                        help="run only the named analyzer(s); repeatable "
                             "(equivalent to --only)")
    parser.add_argument("--q-bits", type=int,
                        default=DEFAULT_ENVELOPE.q_bits,
                        help="envelope: quantization index magnitude bits")
    parser.add_argument("--max-field-elems", type=int,
                        default=DEFAULT_ENVELOPE.max_field_elems,
                        help="envelope: largest spatial field (elements)")
    parser.add_argument("--max-slab-steps", type=int,
                        default=DEFAULT_ENVELOPE.max_slab_steps,
                        help="envelope: most timesteps in one stream")
    args = parser.parse_args(argv)

    env = Envelope(q_bits=args.q_bits,
                   max_field_elems=args.max_field_elems,
                   max_slab_steps=args.max_slab_steps)
    analyzers = ALL_ANALYZERS
    if args.only:
        analyzers = args.only
    if args.analyzer:
        analyzers = tuple(dict.fromkeys(
            (list(args.only) if args.only else []) + args.analyzer))
    report = run_audit(env, analyzers=analyzers)

    for f in report.findings:
        print(f.render())
    counts = report.to_dict()["findings_by_analyzer"]
    ran = ", ".join(analyzers)
    n_warn = len(report.warnings)
    if report.ok:
        tail = f" ({n_warn} warning(s))" if n_warn else ""
        print(f"audit clean: 0 errors{tail} ({ran})")
    else:
        per = ", ".join(f"{k}={v}" for k, v in sorted(counts.items()))
        print(f"audit FAILED: {len(report.errors)} error(s), "
              f"{n_warn} warning(s) [{per}]")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report.to_dict(), fh, indent=2, sort_keys=False)
        print(f"report written to {args.json}")
    return 0 if report.ok else 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
