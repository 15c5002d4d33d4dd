"""Structured findings for the static invariant audit of ``repro_torch``.

Every analyzer reports :class:`Finding` records — never free-form prints —
so the CLI can render them uniformly, ``AUDIT.json`` stays machine-readable
for CI artifacts, and tests can assert on exact (analyzer, invariant)
pairs.  A finding names the *invariant* it protects, not just the symptom:
the five families are the registry completeness matrix, the int32 width
bounds, host-sync freedom of the query path, CUDA launch-grid bounds /
coverage / shared memory, and shard-partition exactness.

Findings carry a ``severity``: ``error`` findings fail the audit (nonzero
exit); ``warning`` findings — today only stale-waiver reports — are printed
and serialized but do not flip ``ok``.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field

#: AUDIT.json schema version.  Bump whenever the serialized shape changes.
#: v2: added ``schema_version``, per-finding ``severity``, ``n_errors`` /
#: ``n_warnings`` counts, and the ``shard_safe_sizes`` per-world table.
SCHEMA_VERSION = 2


@dataclass(frozen=True)
class Finding:
    """One audit violation.

    ``analyzer``  — which pass produced it (``registry`` / ``intwidth`` /
    ``trace`` / ``kernelspec`` / ``sharddisjoint``).
    ``invariant`` — short machine-stable identifier of the violated rule
    (e.g. ``missing-lowering-rule``, ``sumsq-overflow``, ``host-sync``,
    ``read-out-of-bounds``, ``word-owner-overlap``);
    tests and CI gates key on it.
    ``file`` / ``line`` — source location when the pass is syntactic;
    semantic passes (registry, intwidth, sharddisjoint) locate by subject.
    ``subject`` — what the finding is about (op name, accumulator, symbol).
    ``message`` — human-readable statement of the violation.
    ``suggestion`` — the concrete fix (add the rule, widen the type,
    waive with the documented comment syntax, ...).
    ``severity`` — ``error`` (fails the audit) or ``warning`` (reported
    but does not affect the exit code; used for stale waivers).
    """

    analyzer: str
    invariant: str
    message: str
    subject: str = ""
    file: str | None = None
    line: int | None = None
    suggestion: str = ""
    severity: str = "error"

    @property
    def is_error(self) -> bool:
        return self.severity == "error"

    def location(self) -> str:
        if self.file is None:
            return self.subject or "<registry>"
        loc = self.file if self.line is None else f"{self.file}:{self.line}"
        return f"{loc} ({self.subject})" if self.subject else loc

    def render(self) -> str:
        tag = f"{self.analyzer}/{self.invariant}"
        if not self.is_error:
            tag += f" {self.severity}"
        out = f"[{tag}] {self.location()}: {self.message}"
        if self.suggestion:
            out += f"\n    fix: {self.suggestion}"
        return out

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class AuditReport:
    """The full audit result: findings plus the derived safe-size tables."""

    findings: list[Finding] = field(default_factory=list)
    #: analyzer (2)'s machine-readable output: per-scheme maximum safe
    #: field sizes / slab counts under the declared operating envelope.
    safe_sizes: dict = field(default_factory=dict)
    #: analyzer (6)'s machine-readable output: per-world-size safe summary
    #: capacities and collective bit budgets (empty unless sharddisjoint
    #: ran).
    shard_safe_sizes: dict = field(default_factory=dict)

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.is_error]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if not f.is_error]

    @property
    def ok(self) -> bool:
        """Warnings (stale waivers) never fail the audit."""
        return not self.errors

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    def to_dict(self) -> dict:
        by_analyzer: dict[str, int] = {}
        for f in self.findings:
            by_analyzer[f.analyzer] = by_analyzer.get(f.analyzer, 0) + 1
        return {
            "schema_version": SCHEMA_VERSION,
            "ok": self.ok,
            "n_findings": len(self.findings),
            "n_errors": len(self.errors),
            "n_warnings": len(self.warnings),
            "findings_by_analyzer": by_analyzer,
            "findings": [f.to_dict() for f in self.findings],
            "safe_sizes": self.safe_sizes,
            "shard_safe_sizes": self.shard_safe_sizes,
        }
