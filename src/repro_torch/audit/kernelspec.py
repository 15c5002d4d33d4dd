"""Analyzer (5): CUDA launch-grid verification.

Every ``__global__`` instantiation in ``kernels/csrc`` declares a symbolic
spec (:mod:`repro_torch.kernels.specs`); this pass *proves*, for every grid
shape the spec's symbol bounds admit:

* **bounds** — every read of global memory and of a staged shared-memory
  window stays inside its array under its guard, and every write inside its
  allocation (``halo-out-of-bounds`` / ``tile-out-of-bounds``);
* **coverage** — the grid writes every output element exactly once: the
  branches of a split grid tile ``blockIdx.x``, each branch's walk (one
  block per item, a grid-stride or a persistent loop) reaches every work
  item once, and each write is a mixed radix that reaches its extent
  (``grid-write-gap`` / ``grid-write-overlap``); a reduction reads each
  element of its range once (``sum-gap`` / ``sum-overlap``);
* **shared memory** — static ≤ 48 KiB and static plus dynamic ≤ 227 KiB
  (232 448 bytes, H100's opt-in limit per block); a constant per
  instantiation (``smem-budget``), and the spec's static count equals the
  source's ``__shared__`` arrays (``smem-drift``);
* **staged payload windows** — the unpack kernel's ``take4`` and the band
  kernels' row unpacks read only words inside their staged buffers, by
  bounded-exhaustive sweep over every width and offset (``unpack-oob``);
* **no output multiply** — no plain float ``*`` feeds a store to an output
  (the FMA-contraction hazard: ``a * b + c`` may contract into one fused
  multiply-add, rounding once where torch rounds twice); an explicit
  ``__fmul_rn`` / ``__fadd_rn`` is never contracted, and a product that is
  then rounded to an integer (``rintf``) is not an output multiply.
  ``// audit: waive(output-multiply)`` on the store line or the line above
  exempts it;
* **sites** — every ``__global__`` function and every launch (``<<<…>>>``,
  ``cudaLaunchKernelEx``) has a spec (``undeclared-kernel``), every spec
  its site (``stale-kernel-spec``), and the instantiation tables that
  ``hsz_func_attrs`` reads list exactly the specs, in
  :data:`~repro_torch.kernels.specs.KERNEL_IDS` order (``kernel-id-drift``);
* **constants** — the ``constexpr`` values the specs use equal the
  source's (``constexpr-drift``), and the facts hold at concrete launches
  of every tiling limit's edge (``spec-fact-violated``);
* **launchers** — ``build.SIGNATURES`` equals the parsed ``extern "C"``
  prototypes: names, arity, ``int`` ↔ ``c_int``, ``long long`` ↔
  ``c_longlong``, pointers and the stream ↔ ``c_void_p``
  (``launcher-signature``).  ``ctypes`` checks none of it at a call.

Abstract domain: polynomials over the spec symbols with interval bounds.
``e >= 0`` is proven by substituting each bounded symbol ``s`` with
``lo + δ`` or ``hi − δ`` (fresh ``δ >= 0``) and checking that some branch
expands to a polynomial with only non-negative coefficients — sound (never
accepts a violable bound), conservative (may reject a true one, which
surfaces as a finding to fix or respecify, never silence).
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from .findings import Finding
from .intwidth import DEFAULT_ENVELOPE, Envelope

_ANALYZER = "kernelspec"

_FRESH = "δ"  # reserved prefix for nonneg slack variables
_GUARD_RE = re.compile(r"^\s*(\w+)\s*(<=|>=)\s*(.+?)\s*$")
_FACT_RE = re.compile(r"^\s*(\w+)\s*==\s*(.+?)\s*$")
_WAIVE_RE = re.compile(r"//\s*audit:\s*waive\(([a-z\-,\s]+)\)")

#: the rows and columns of the edge shapes the facts are checked at: one
#: past every tiling limit of the code (32-row and 128-column tiles, 4224
#: columns of narrow corner sums, 65535 grid rows, spans of 2048 values).
EDGE_ROWS = (1, 31, 32, 33, 65537)
EDGE_COLS = (1, 3, 127, 128, 129, 4224, 4225)
#: the fields of a batch the batched instantiations are also checked at
EDGE_BATCH = 3


# ---------------------------------------------------------------------------
# polynomial domain
# ---------------------------------------------------------------------------

class Poly:
    """Integer polynomial over named symbols (dict monomial -> coeff).

    A monomial is a sorted tuple of ``(symbol, power)`` pairs; the empty
    tuple is the constant term.  Supports +, -, *, substitution, and exact
    equality — everything the bounds/coverage proofs need.
    """

    __slots__ = ("terms",)

    def __init__(self, terms: dict | None = None):
        self.terms = {m: c for m, c in (terms or {}).items() if c != 0}

    @classmethod
    def const(cls, n: int) -> "Poly":
        return cls({(): int(n)})

    @classmethod
    def var(cls, name: str) -> "Poly":
        return cls({((name, 1),): 1})

    def vars(self) -> set[str]:
        return {s for m in self.terms for s, _ in m}

    def is_zero(self) -> bool:
        return not self.terms

    def const_value(self) -> int | None:
        if not self.terms:
            return 0
        if set(self.terms) == {()}:
            return self.terms[()]
        return None

    def __eq__(self, other) -> bool:
        return isinstance(other, Poly) and self.terms == other.terms

    def __hash__(self):
        return hash(frozenset(self.terms.items()))

    def __add__(self, other: "Poly") -> "Poly":
        out = dict(self.terms)
        for m, c in other.terms.items():
            out[m] = out.get(m, 0) + c
        return Poly(out)

    def __neg__(self) -> "Poly":
        return Poly({m: -c for m, c in self.terms.items()})

    def __sub__(self, other: "Poly") -> "Poly":
        return self + (-other)

    def __mul__(self, other: "Poly") -> "Poly":
        out: dict = {}
        for m1, c1 in self.terms.items():
            for m2, c2 in other.terms.items():
                powers: dict[str, int] = {}
                for s, p in m1 + m2:
                    powers[s] = powers.get(s, 0) + p
                m = tuple(sorted(powers.items()))
                out[m] = out.get(m, 0) + c1 * c2
        return Poly(out)

    def subst(self, name: str, repl: "Poly") -> "Poly":
        """Replace every occurrence of ``name`` by the polynomial ``repl``."""
        out = Poly()
        for m, c in self.terms.items():
            power = 0
            rest = []
            for s, p in m:
                if s == name:
                    power = p
                else:
                    rest.append((s, p))
            term = Poly({tuple(rest): c})
            for _ in range(power):
                term = term * repl
            out = out + term
        return out

    def render(self) -> str:
        if not self.terms:
            return "0"
        parts = []
        for m, c in sorted(self.terms.items()):
            sym = "*".join(s if p == 1 else f"{s}^{p}" for s, p in m)
            parts.append(f"{c}" if not sym else
                         (sym if c == 1 else f"{c}*{sym}"))
        return " + ".join(parts)


def parse_expr(expr: str, consts: dict[str, int] | None = None) -> Poly:
    """Parse an integer expression (``+ - *``, parentheses, names,
    literals; ``//`` between constants) into a :class:`Poly`; names in
    ``consts`` are constants."""
    consts = consts or {}

    def rec(node: ast.AST) -> Poly:
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return Poly.const(node.value)
        if isinstance(node, ast.Name):
            if node.id in consts:
                return Poly.const(consts[node.id])
            return Poly.var(node.id)
        if isinstance(node, ast.BinOp):
            left, right = rec(node.left), rec(node.right)
            if isinstance(node.op, ast.Add):
                return left + right
            if isinstance(node.op, ast.Sub):
                return left - right
            if isinstance(node.op, ast.Mult):
                return left * right
            if isinstance(node.op, ast.FloorDiv):
                a, b = left.const_value(), right.const_value()
                if a is not None and b:
                    return Poly.const(a // b)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return -rec(node.operand)
        raise ValueError(f"unsupported spec expression: {expr!r}")

    return rec(ast.parse(expr, mode="eval").body)


# ---------------------------------------------------------------------------
# the nonnegativity prover
# ---------------------------------------------------------------------------

def prove_nonneg(p: Poly, order: list[str],
                 bounds: dict[str, tuple[Poly, Poly | None]]) -> bool:
    """Prove ``p >= 0`` for every assignment inside the bound box.

    Substitutes the first bounded symbol present by ``lo + δ`` (valid for
    the whole domain above ``lo``) or, when an upper bound exists, by
    ``hi − δ`` (valid below ``hi``); a branch succeeds when the fully
    substituted polynomial has only non-negative coefficients over the
    remaining δ's.  Bound expressions may only reference symbols *later*
    in ``order``.
    """
    for k, sym in enumerate(order):
        if sym not in p.vars():
            continue
        lo, hi = bounds[sym]
        # one slack per symbol: an index into the shrinking order list would
        # name two slacks alike down the recursion and let them cancel
        slack = Poly.var(f"{_FRESH}{sym}")
        cands = [p.subst(sym, lo + slack)]
        if hi is not None:
            cands.append(p.subst(sym, hi - slack))
        return any(prove_nonneg(c, order[k + 1:], bounds) for c in cands)
    if any(not v.startswith(_FRESH) for v in p.vars()):
        return False  # a symbol with no declared bound survived
    return all(c >= 0 for c in p.terms.values())


# ---------------------------------------------------------------------------
# spec checks
# ---------------------------------------------------------------------------

class _SpecCtx:
    """One spec's constants, facts, symbol bounds (digit variables bounded by
    their counts) in a dependency order, and the prover entry points."""

    def __init__(self, spec, consts: dict[str, int]):
        self.spec = spec
        self.consts = consts
        self.facts: list[tuple[str, Poly]] = []
        for fact in spec.facts:
            m = _FACT_RE.match(fact)
            if not m:
                raise ValueError(f"{spec.name}: malformed fact {fact!r}")
            self.facts.append((m.group(1), self.parse(m.group(2))))
        raw: dict[str, tuple[str, str | None]] = {}
        for br in spec.branches:
            covers = [br.walk] + ([br.items] if br.items else [])
            covers += [c for w in br.writes for c in w.lead + w.dims]
            covers += [c for s in br.sums for c in s.dims]
            for cover in covers:
                for d in cover.digits:
                    want = ("0", None if d.count is None
                            else f"({d.count}) - 1")
                    have = raw.setdefault(d.var, want)
                    if (have[1] is None) != (want[1] is None) or (
                            want[1] is not None and not (
                                self.parse(have[1]) - self.parse(want[1])
                            ).is_zero()):
                        raise ValueError(
                            f"{spec.name}: digit {d.var} has two counts")
        for sym, b in spec.bounds.items():
            raw.setdefault(sym, b)
        self.bounds = {
            s: (self.poly(lo), self.poly(hi) if hi is not None else None)
            for s, (lo, hi) in raw.items()}
        self.order = self._order(list(raw))

    def _order(self, names: list[str]) -> list[str]:
        """Each symbol before every symbol its bounds reference."""
        deps = {s: ((lo.vars() | (hi.vars() if hi is not None else set()))
                    & set(names)) - {s}
                for s, (lo, hi) in self.bounds.items()}
        order: list[str] = []
        placed: set[str] = set()
        users = {s: {t for t in names if s in deps[t]} for s in names}
        while len(order) < len(names):
            ready = [s for s in names if s not in placed
                     and users[s] <= placed]
            if not ready:
                raise ValueError(f"{self.spec.name}: cyclic symbol bounds")
            order.append(ready[0])
            placed.add(ready[0])
        return order

    def parse(self, expr: str) -> Poly:
        return parse_expr(expr, self.consts)

    def rw(self, p: Poly) -> Poly:
        """Eliminate fact-defined symbols (``n0 == (n_rt - 1)*TH + e0``)."""
        for _ in range(len(self.facts) + 1):
            q = p
            for sym, rhs in self.facts:
                q = q.subst(sym, rhs)
            if q == p:
                return p
            p = q
        return p

    def poly(self, expr: str) -> Poly:
        return self.rw(self.parse(expr))

    def nonneg(self, p: Poly, guards: tuple[str, ...] = ()) -> bool:
        bounds = self.bounds
        for guard in guards:
            g = _GUARD_RE.match(guard)
            if not g:
                raise ValueError(f"{self.spec.name}: malformed guard {guard!r}")
            sym, op, rhs = g.group(1), g.group(2), self.poly(g.group(3))
            lo, hi = bounds[sym]
            bounds = dict(bounds)
            bounds[sym] = (rhs, hi) if op == ">=" else (lo, rhs)
        return prove_nonneg(self.rw(p), self.order, bounds)

    def equal(self, a: Poly, b: Poly) -> bool:
        return self.rw(a - b).is_zero() or (self.nonneg(a - b)
                                            and self.nonneg(b - a))


def _finding(invariant: str, spec, message: str, suggestion: str = "",
             subject: str = "") -> Finding:
    return Finding(_ANALYZER, invariant, message,
                   subject=subject or spec.name,
                   file=f"src/repro_torch/kernels/csrc/{spec.source}",
                   suggestion=suggestion)


def _check_cover(ctx: _SpecCtx, cover, what: str, gap: str,
                 overlap: str) -> list[Finding]:
    """Exactly-once coverage of ``[0, extent)`` by one mixed-radix cover."""
    spec = ctx.spec
    ext = ctx.poly(cover.extent)
    stride = Poly.const(1)
    for k, d in enumerate(cover.digits):
        got = ctx.poly(d.stride)
        if not ctx.equal(got, stride):
            kind = gap if ctx.nonneg(got - stride - Poly.const(1)) else overlap
            return [_finding(
                kind, spec,
                f"{what}: digit {d.var} steps by {got.render()} where the "
                f"digits below it span {stride.render()} — "
                + ("elements between steps are never reached" if kind == gap
                   else "two iterations reach the same element"),
                subject=f"{spec.name}.{what}")]
        if d.count is None:
            if k != len(cover.digits) - 1 or not cover.clip:
                return [_finding(
                    overlap, spec,
                    f"{what}: loop digit {d.var} must be the outermost and "
                    "end at a guard on the extent", subject=f"{spec.name}.{what}")]
            return []
        stride = stride * ctx.poly(d.count)
    if cover.clip:
        if not ctx.nonneg(stride - ext):
            return [_finding(
                gap, spec,
                f"{what}: the digits reach {stride.render()} elements, which "
                f"need not cover the extent {ext.render()} for every "
                "admissible launch", subject=f"{spec.name}.{what}")]
        return []
    if not ctx.equal(stride, ext):
        kind = gap if ctx.nonneg(ext - stride - Poly.const(1)) else overlap
        return [_finding(
            kind, spec,
            f"{what}: the digits reach {stride.render()} elements but the "
            f"unguarded extent is {ext.render()}",
            subject=f"{spec.name}.{what}")]
    return []


def _check_branches(ctx: _SpecCtx) -> list[Finding]:
    """The branches tile ``[0, grid)`` of ``blockIdx.x`` in order, and each
    walk's block digit spans its branch."""
    spec = ctx.spec
    out = []
    start = Poly.const(0)
    for i, br in enumerate(spec.branches):
        b0, n = ctx.poly(br.start), ctx.poly(br.count)
        if not ctx.equal(b0, start):
            out.append(_finding(
                "grid-write-gap" if ctx.nonneg(b0 - start - Poly.const(1))
                else "grid-write-overlap", spec,
                f"branch {i} starts at block {b0.render()}, not at "
                f"{start.render()}"))
        blocks = Poly.const(1)
        for d in br.walk.digits:
            if d.count is not None:
                blocks = blocks * ctx.poly(d.count)
        if not ctx.equal(blocks, n):
            out.append(_finding(
                "grid-write-gap", spec,
                f"branch {i}'s walk spans {blocks.render()} blocks, not the "
                f"branch's {n.render()}"))
        start = start + n
    if not ctx.equal(start, ctx.poly(spec.grid)):
        out.append(_finding(
            "grid-write-gap", spec,
            f"the branches span {start.render()} blocks but the grid is "
            f"{ctx.poly(spec.grid).render()}"))
    return out


def _is_unit(ctx: _SpecCtx, count: str | None) -> bool:
    return count is not None and ctx.poly(count) == Poly.const(1)


def _check_writes(ctx: _SpecCtx, br) -> list[Finding]:
    spec = ctx.spec
    out: list[Finding] = []
    walk_vars = [d.var for d in br.walk.digits
                 if not _is_unit(ctx, d.count)]
    for w in br.writes:
        digit_vars = {d.var for c in w.lead + w.dims for d in c.digits}
        if w.per == "block":
            per = walk_vars[:1]
        elif br.items is not None:
            per = [d.var for d in br.items.digits]
        elif br.item:
            per = [br.item]
        else:
            per = walk_vars
        required = (set(per) | set(w.threads)) - set(w.fixed)
        racy = sorted(required - digit_vars)
        if racy:
            out.append(_finding(
                "grid-write-overlap", spec,
                f"output {w.array!r}: {racy} do not appear in its index — "
                "every value of them rewrites the same elements (a write "
                "race between blocks or threads)",
                subject=f"{spec.name}.{w.array}",
                suggestion="index the output by every block, item and "
                           "thread variable, or pin a thread by an "
                           "equality guard (fixed=)"))
            continue
        for d, cover in enumerate(w.lead):
            out += _check_cover(ctx, cover, f"output {w.array!r} batch dim {d}",
                                "grid-write-gap", "grid-write-overlap")
        for d, cover in enumerate(w.dims):
            out += _check_cover(ctx, cover, f"output {w.array!r} dim {d}",
                                "grid-write-gap", "grid-write-overlap")
        if w.alloc:
            for d, (cover, alloc) in enumerate(zip(w.dims, w.alloc)):
                if not ctx.nonneg(ctx.poly(alloc) - ctx.poly(cover.extent)):
                    out.append(_finding(
                        "tile-out-of-bounds", spec,
                        f"output {w.array!r} dim {d}: the written window "
                        f"{cover.extent} can pass the allocation {alloc}",
                        subject=f"{spec.name}.{w.array}"))
    for s in br.sums:
        for d, cover in enumerate(s.dims):
            out += _check_cover(ctx, cover, f"sum over {s.array!r} dim {d}",
                                "sum-gap", "sum-overlap")
    return out


def _check_reads(ctx: _SpecCtx, br) -> list[Finding]:
    spec = ctx.spec
    out = []
    for r in br.reads:
        guards = r.guard or ("",) * len(r.index)
        for d, (idx, ext, guard) in enumerate(zip(r.index, r.extent, guards)):
            i, e = ctx.poly(idx), ctx.poly(ext)
            restrict = tuple(g for g in guard.split(";") if _GUARD_RE.match(g))
            lo_ok = guard in ("clip", ">=") or ctx.nonneg(i, restrict)
            hi_ok = guard in ("clip", "<") or ctx.nonneg(
                e - Poly.const(1) - i, restrict)
            if not (lo_ok and hi_ok):
                side = "below 0" if not lo_ok else "past the extent"
                where = "shared window" if r.shared else "array"
                out.append(_finding(
                    "halo-out-of-bounds", spec,
                    f"read of {where} {r.array}[{', '.join(r.index)}] dim {d} "
                    f"(guard {guard or 'none'}) can index {side} of extent "
                    f"{ext} for some admissible launch",
                    subject=f"{spec.name}.{r.array}",
                    suggestion="guard the read at the plane's edge, or "
                               "shrink the staged window's index"))
                break
    return out


def _check_smem(ctx: _SpecCtx) -> list[Finding]:
    from ..kernels import specs as kspecs

    spec = ctx.spec
    static = ctx.parse(spec.smem_static).const_value()
    dynamic = ctx.parse(spec.smem_dynamic).const_value()
    if static is None or dynamic is None:
        return [_finding("smem-budget", spec,
                         "shared memory does not reduce to a constant")]
    if static > kspecs.STATIC_SMEM_LIMIT:
        return [_finding(
            "smem-budget", spec,
            f"static shared memory {static} bytes exceeds the "
            f"{kspecs.STATIC_SMEM_LIMIT}-byte limit of __shared__ arrays",
            suggestion="move the buffers to dynamic shared memory (opted "
                       "in with cudaFuncSetAttribute) or shrink the tile")]
    if static + dynamic > kspecs.SMEM_OPTIN_LIMIT:
        return [_finding(
            "smem-budget", spec,
            f"static + dynamic shared memory {static + dynamic} bytes "
            f"exceeds {kspecs.SMEM_OPTIN_LIMIT} bytes per block",
            suggestion="shrink the tile or the staged buffers")]
    return []


def check_spec(spec, consts: dict[str, int] | None = None) -> list[Finding]:
    """All symbolic checks for one :class:`KernelSpec` (fixture entry)."""
    if consts is None:
        from ..kernels.specs import CONSTANTS
        consts = CONSTANTS.get(spec.source, {})
    try:
        ctx = _SpecCtx(spec, consts)
        findings = _check_branches(ctx)
        for br in spec.branches:
            findings += _check_cover(ctx, br.walk, "walk", "grid-write-gap",
                                     "grid-write-overlap")
            if br.items is not None:
                findings += _check_cover(ctx, br.items, "work items",
                                         "grid-write-gap", "grid-write-overlap")
            findings += _check_writes(ctx, br)
            findings += _check_reads(ctx, br)
        findings += _check_smem(ctx)
    except (ValueError, KeyError) as e:
        return [Finding(_ANALYZER, "spec-unprovable", str(e),
                        subject=spec.name)]
    return findings


# ---------------------------------------------------------------------------
# concrete launches: the facts and bounds at real shapes
# ---------------------------------------------------------------------------

def launch_symbols(spec, args: dict) -> dict[str, int]:
    """Every parametrized symbol of ``spec`` at one launch (``args``: the
    launcher's sizes, ``n0``, ``n1``, ``n``, ``sms``, ``per_sm``, ``B``
    (fields of a batch; 1 where absent), ...)."""
    from ..kernels.specs import evaluate

    env = {"B": 1, **args}
    for sym, expr in spec.params.items():
        env[sym] = evaluate(expr, spec.source, env)
    return env


def check_launch(spec, args: dict) -> list[str]:
    """The spec's facts and its parametrized symbols' bounds at one
    concrete launch; returns what failed."""
    from ..kernels.specs import evaluate

    env = launch_symbols(spec, args)
    bad = []
    for fact in spec.facts:
        lhs, rhs = fact.split("==")
        if lhs.strip() in env and evaluate(lhs, spec.source, env) != evaluate(
                rhs, spec.source, env):
            bad.append(f"fact {fact} fails at {args}")
    for sym, (lo, hi) in spec.bounds.items():
        if sym not in spec.params:
            continue
        v, a = env[sym], evaluate(lo, spec.source, env)
        b = evaluate(hi, spec.source, env) if hi is not None else None
        if v < a or (b is not None and v > b):
            bad.append(f"{sym} = {v} outside [{a}, {b}] at {args}")
    return bad


def _cover_counts(cover, spec, env) -> tuple[int, "object", list[str]]:
    """How often one launch reaches each index of a cover's extent:
    ``(extent, counts, problems)``."""
    import numpy as np

    from ..kernels.specs import evaluate

    extent = evaluate(cover.extent, spec.source, env)
    idx = np.zeros(1, dtype=np.int64)
    for d in cover.digits:
        stride = evaluate(d.stride, spec.source, env)
        count = (evaluate(d.count, spec.source, env) if d.count is not None
                 else -(-extent // max(stride, 1)) + 1)
        idx = (idx[:, None] + stride * np.arange(count, dtype=np.int64)).ravel()
    problems = []
    if cover.clip:
        idx = idx[idx < extent]
    elif idx.size and idx.max() >= extent:
        problems.append(f"index {int(idx.max())} past extent {extent}")
    idx = idx[(idx >= 0) & (idx < extent)]
    counts = np.bincount(idx, minlength=extent)
    if counts.size and counts.min() < 1:
        problems.append(f"index {int(np.argmin(counts))} of {extent} never "
                        "reached")
    if counts.size and counts.max() > 1:
        problems.append(f"index {int(np.argmax(counts))} of {extent} reached "
                        f"{int(counts.max())} times")
    return extent, counts, problems


def concrete_coverage(spec, args: dict) -> dict[str, tuple[tuple, list]]:
    """At one concrete launch, every output array's extents (one field's,
    without the batch dims) and what is wrong with its coverage (empty when
    every element is written once, the batch dims included); the walk and
    the item decomposition under ``"<walk>"`` / ``"<items>"``."""
    env = launch_symbols(spec, args)
    out: dict[str, tuple[tuple, list]] = {}
    for br in spec.branches:
        for key, cover in (("<walk>", br.walk), ("<items>", br.items)):
            if cover is not None:
                ext, _, probs = _cover_counts(cover, spec, env)
                old = out.get(key, ((), []))
                out[key] = (old[0] + (ext,), old[1] + probs)
        for w in br.writes:
            dims = [_cover_counts(c, spec, env) for c in w.dims]
            lead = [_cover_counts(c, spec, env) for c in w.lead]
            out[w.array] = (tuple(e for e, _, _ in dims),
                            [p for _, _, ps in lead + dims for p in ps])
    return out


def edge_launches(spec) -> list[dict]:
    """The launches the facts are checked at: every row and column edge of
    a tiling limit, a span edge for the unpack, at two occupancies; a
    batched instantiation (``B`` among its symbols) at one field and at
    :data:`EDGE_BATCH` fields."""
    out = []
    batches = (1, EDGE_BATCH) if "B" in spec.bounds else (1,)
    for sms, per_sm in ((132, 1), (132, 8)):
        for batch in batches:
            if spec.source == "unpack.cu":
                for k in (1, 2, 7):
                    for n in (2048 * k - 1, 2048 * k, 2048 * k + 1):
                        out.append({"n": n, "sms": sms, "per_sm": per_sm,
                                    "B": batch})
                continue
            for n0 in EDGE_ROWS:
                for n1 in EDGE_COLS:
                    if spec.source in ("stencil_dq.cu",) and min(n0, n1) < 3:
                        continue
                    a = {"n0": n0, "n1": n1, "sms": sms, "per_sm": per_sm,
                         "b0": 1, "b1": 1, "n_words": n0 * n1, "n": n0 * n1,
                         "n_blocks": n0, "s_len": n1, "B": batch}
                    out.append(a)
    return out


def _check_launches(spec) -> list[Finding]:
    if spec.name == "prefix_stats_tile_kernel<false>":
        # launched only on planes whose tiles lie within 128 corner sums
        cases = [a for a in edge_launches(spec)
                 if 4 * (-(-a["n1"] // 128) - 1) <= 128]
    elif spec.name == "prefix_stats_tile_kernel<true>":
        cases = [a for a in edge_launches(spec)
                 if 4 * (-(-a["n1"] // 128) - 1) > 128]
    else:
        cases = edge_launches(spec)
    for args in cases:
        bad = check_launch(spec, args)
        if bad:
            return [_finding("spec-fact-violated", spec, bad[0],
                             suggestion="make the spec's facts and bounds "
                                        "describe what the launcher does")]
    return []


# ---------------------------------------------------------------------------
# staged payload windows (bounded-exhaustive)
# ---------------------------------------------------------------------------

def check_unpack_lemma(pad: int | None = None) -> list[Finding]:
    """``unpack.cu``: every word ``take4`` reads lies inside the staged span
    buffer of ``span_words(bits) + PAD`` words.

    Up to 16 bits a thread's 4 values at bit offset ``off = v*bits`` come
    from words ``k .. k + 2`` (``k = off >> 5``); above, value ``e`` from
    words ``o >> 5`` and ``(o >> 5) + 1`` (``o = off + e*bits``).  Every
    width 1–31 and every thread's first value ``v`` (a multiple of 4 below
    SPAN) is swept.
    """
    from ..kernels.specs import CONSTANTS

    c = CONSTANTS["unpack.cu"]
    pad = c["PAD"] if pad is None else pad
    span = c["SPAN"]
    for bits in range(1, 32):
        limit = span // 32 * bits + pad - 1
        for v in range(0, span, 4):
            off = v * bits
            if bits <= 16:
                top = (off >> 5) + 2
            else:
                top = max(((off + e * bits) >> 5) + 1 for e in range(4))
            if top > limit:
                return [Finding(
                    _ANALYZER, "unpack-oob",
                    f"take4 at bits={bits}, value {v} reads staged word "
                    f"{top} but the span buffer holds {limit + 1} "
                    f"(span_words + PAD = {span // 32 * bits} + {pad})",
                    subject="unpack_kernel",
                    file="src/repro_torch/kernels/csrc/unpack.cu",
                    suggestion=f"restore PAD = {c['PAD']} in unpack.cu "
                               "and kernels/specs.py")]
    return []


def min_unpack_pad() -> int:
    """The smallest ``PAD`` for which :func:`check_unpack_lemma` passes."""
    pad = 0
    while check_unpack_lemma(pad):
        pad += 1
    return pad


def check_lorenzo_staging(ld: int | None = None) -> list[Finding]:
    """``lorenzo_band.cu``: a payload row segment of ``nc`` values (128 in
    the edge pass, 129 in the stencil pass) staged from the 16-byte boundary
    at or before its first bit (in-chunk offset ``base`` in 0..127): the
    16-byte copies and every unpack read (``row4``'s 3-word window up to 16
    bits, ``value_at``'s 2 words above) stay inside a row of ``LD`` words."""
    from ..kernels.specs import CONSTANTS

    c = CONSTANTS["lorenzo_band.cu"]
    ld = c["LD"] if ld is None else ld
    for nc in (c["TW"], c["TW"] + 1):
        for bits in range(1, 32):
            for base in range(128):
                nw = ((base + nc * bits - 1) >> 5) + 1
                copied = 4 * -(-nw // 4) - 1
                reads = []
                for c0 in range(0, c["TW"], 4):
                    off = base + c0 * bits
                    reads.append((off >> 5) + 2 if bits <= 16 else max(
                        ((off + e * bits) >> 5) + 1 for e in range(4)))
                if nc > c["TW"]:
                    reads.append(((base + c["TW"] * bits) >> 5) + 1)
                top = max(copied, *reads)
                if top > ld - 1:
                    return [Finding(
                        _ANALYZER, "unpack-oob",
                        f"Lorenzo staging of {nc} values at bits={bits}, "
                        f"offset {base}: word {top} past a row of {ld}",
                        subject="lorenzo_band fetch/row4",
                        file="src/repro_torch/kernels/csrc/lorenzo_band.cu")]
    return []


def check_blockmean_staging(ld: int | None = None) -> list[Finding]:
    """``blockmean_band.cu``: a halo row of up to ``HC`` values staged from
    its first word (offset ``b31`` in 0..31), its words and the 0 sentinel
    after them, and every value's two-word funnel read stay inside a row of
    ``LD`` words and inside the staged words and sentinel."""
    from ..kernels.specs import CONSTANTS

    c = CONSTANTS["blockmean_band.cu"]
    ld = c["LD"] if ld is None else ld
    hc = c["HC"]
    for bits in range(1, 32):
        for b31 in range(32):
            for left_edge in (False, True):
                # values jlo .. jhi; at the left edge jlo = j0 = 0 and halo
                # column 0 lies outside the plane
                n_vals = hc - 1 if left_edge else hc
                n_words = ((b31 + n_vals * bits - 1) >> 5) + 1
                base = b31 - (bits if left_edge else 0)
                first = 1 if left_edge else 0
                top = max(((cc * bits + base) >> 5) + 1
                          for cc in range(first, hc))
                if n_words > ld - 1 or top > n_words:
                    return [Finding(
                        _ANALYZER, "unpack-oob",
                        f"block-mean staging at bits={bits}, offset {b31}: "
                        f"{n_words} words + sentinel, reads up to word {top}, "
                        f"in a row of {ld}",
                        subject="blockmean_band fetch/expand",
                        file="src/repro_torch/kernels/csrc/blockmean_band.cu")]
    return []


# ---------------------------------------------------------------------------
# the CUDA sources
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"0[xX][0-9a-fA-F]+[uUlL]*|\d+\.\d*(?:[eE][-+]?\d+)?[fF]?|\.\d+[fF]?"
    r"|\d+[eE][-+]?\d+[fF]?|\d+[uUlLfF]*|\w+|->|<<=|>>=|<<|>>|&&|\|\|"
    r"|[-+*/%&|^!<>=]=|[-+*/%&|^~!<>=?:.,;()\[\]{}]")
_CONTROL = frozenset({"if", "for", "while", "switch", "catch", "return",
                      "constexpr",
                      "sizeof", "defined"})


def strip_comments(text: str) -> str:
    """Comments and string contents blanked, offsets and newlines kept."""
    out = list(text)

    def blank(a, b):
        for k in range(a, b):
            if out[k] != "\n":
                out[k] = " "
    for m in re.finditer(r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\])*"', text, re.S):
        if m.group(0).startswith('"'):
            blank(m.start() + 1, m.end() - 1)
        else:
            blank(m.start(), m.end())
    return "".join(out)


def _header(head: str) -> tuple[str, str, str] | None:
    """``(name, parameters, text before the name)`` when ``head`` (the text
    before a ``{``) ends a function header, else None."""
    h = head.rstrip()
    for word in ("const", "noexcept"):
        if h.endswith(word):
            h = h[:-len(word)].rstrip()
    if not h.endswith(")"):
        return None
    depth = 0
    for k in range(len(h) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(h[k], 0)
        if depth == 0:
            break
    else:
        return None
    before = h[:k].rstrip()
    if before.endswith(">"):  # explicit template arguments
        angle = 0
        for q in range(len(before) - 1, -1, -1):
            angle += {">": 1, "<": -1}.get(before[q], 0)
            if angle == 0:
                before = before[:q].rstrip()
                break
    m = re.search(r"(\w+)$", before)
    if not m or m.group(1) in _CONTROL or m.group(1).startswith("__launch"):
        return None
    return m.group(1), h[k + 1:-1], before[:m.start()]


class _Source:
    """One ``.cu`` / ``.cuh`` file: comment-free text, tokens, function
    definitions (name, parameters, body span) by brace matching."""

    def __init__(self, path: Path, text: str | None = None):
        self.path = path
        self.name = path.name
        self.raw = path.read_text() if text is None else text
        self.text = strip_comments(self.raw)
        self.funcs: dict[str, list[tuple[int, int, str, str]]] = {}
        stack: list[int] = []
        opened: dict[int, tuple[str, str, str]] = {}
        last = 0
        for m in re.finditer(r"[{};]", self.text):
            ch = m.group(0)
            if ch == "{":
                stack.append(m.start())
                hit = _header(self.text[last:m.start()])
                if hit:
                    opened[m.start()] = hit
            elif ch == "}" and stack:
                start = stack.pop()
                hit = opened.pop(start, None)
                if hit:
                    name, params, ret = hit
                    self.funcs.setdefault(name, []).append(
                        (start, m.end(), params, ret))
            last = m.end()

    def line_of(self, pos: int) -> int:
        return self.text.count("\n", 0, pos) + 1

    def enclosing(self, pos: int) -> str | None:
        best = None
        for name, spans in self.funcs.items():
            for a, b, _, _ in spans:
                if a < pos < b and (best is None or a > best[0]):
                    best = (a, name)
        return best[1] if best else None

    def globals(self) -> list[tuple[str, int]]:
        return [(m.group(1), self.line_of(m.start())) for m in re.finditer(
            r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)"
            r"\s*\(", self.text)]

    def launches(self) -> list[tuple[str, str | None, int]]:
        out = []
        for m in re.finditer(r"(\w+)\s*(?:<[^;{}()<>]*>)?\s*<<<", self.text):
            out.append((m.group(1), self.enclosing(m.start()),
                        self.line_of(m.start())))
        for m in re.finditer(r"cudaLaunchKernelEx\s*\([^,]*,\s*(\w+)",
                             self.text):
            out.append((m.group(1), self.enclosing(m.start()),
                        self.line_of(m.start())))
        return out

    def constexprs(self, known: dict[str, int]) -> dict[str, int]:
        out: dict[str, int] = {}
        for m in re.finditer(r"constexpr\s+(?:int|unsigned|long long)\s+(\w+)"
                             r"\s*=\s*([^;]+);", self.text):
            try:
                out[m.group(1)] = eval_c(m.group(2), {**known, **out})
            except (ValueError, SyntaxError, NameError, ZeroDivisionError):
                continue
        return out

    def table(self) -> list[tuple[str, str]]:
        """``(name, kernel expression)`` of each KernelInfo entry."""
        return [(m.group(1), re.sub(r"\s+", " ", m.group(2)))
                for m in re.finditer(
                    r'\{\s*"([^"]*)"\s*,\s*\(const void\s*\*\)\s*'
                    r"(\w+(?:\s*<[^<>]*>)?)", self.raw)]

    def shared_bytes(self, func: str, consts: dict[str, int],
                     names: tuple[str, ...] = ()) -> int:
        """Static ``__shared__`` bytes of ``func`` and the functions it
        calls (transitively); only the arrays in ``names`` if given."""
        seen: set[str] = set()
        work = [func]
        total = 0
        while work:
            f = work.pop()
            if f in seen or f not in self.funcs:
                continue
            seen.add(f)
            for a, b, _, _ in self.funcs[f]:
                body = self.text[a:b]
                for m in re.finditer(
                        r"(?<!extern )__shared__\s+(?:__align__\(\d+\)\s+)?"
                        r"(\w+)\s+(\w+)((?:\[[^\]]+\])+)\s*;", body):
                    if names and m.group(2) not in names:
                        continue
                    n = _TYPE_BYTES.get(m.group(1), 4)
                    for dim in re.findall(r"\[([^\]]+)\]", m.group(3)):
                        n *= eval_c(dim, consts)
                    total += n
                work += [w for w in re.findall(r"\b(\w+)\s*(?:<[^;{}()]*>)?\s*\(",
                                               body) if w in self.funcs]
        return total


_TYPE_BYTES = {"double": 8, "int64_t": 8, "uint64_t": 8, "char": 1,
               "int8_t": 1, "uint8_t": 1, "int16_t": 2, "uint16_t": 2}


def eval_c(expr: str, consts: dict[str, int]) -> int:
    """A C integer constant expression over ``consts`` (``/`` truncates,
    ``sizeof`` of 4- and 8-byte types, casts dropped)."""
    e = re.sub(r"\(\s*(?:int|unsigned|long long)\s*\)", "", expr)
    e = re.sub(r"sizeof\s*\(\s*(\w+)\s*\)",
               lambda m: str(_TYPE_BYTES.get(m.group(1), 4)), e)
    e = re.sub(r"\b(0[xX][0-9a-fA-F]+|\d+)[uUlL]+\b", r"\1", e)
    tree = ast.parse(e.replace("/", "//"), mode="eval")
    for n in ast.walk(tree):
        if isinstance(n, ast.Name) and n.id not in consts:
            raise NameError(n.id)
        if isinstance(n, ast.Call):
            raise ValueError(e)
    return int(eval(compile(tree, "<c>", "eval"),  # noqa: S307
                    {"__builtins__": {}}, dict(consts)))


# -- output-multiply lint -----------------------------------------------------

_FLOAT_CALLS = re.compile(
    r"^(?:__(?:u?int|ll|ull|double|half)2float\w*|__(?:u?int|ll|ull|float)2double"
    r"\w*|__hiloint2double|__f(?:mul|add|sub|div|ma|rcp|sqrt)\w*|__d(?:mul|add"
    r"|sub|div)\w*|fmaf?|sqrtf?|expf?|logf?|fabsf?|fminf?|fmaxf?|powf?)$")
_ROUND_CALLS = re.compile(
    r"^(?:rintf?|lrintf?|llrintf?|nearbyintf?|roundf?|floorf?|ceilf?|truncf?"
    r"|__float2u?int_\w+|__float2u?ll_\w+|__double2u?int_\w+|__double2u?ll_\w+)$")
_STORE_CALLS = {"__stcs": 1, "__stcg": 1, "__stwt": 1, "__stwb": 1}
_FLOAT_LIT = re.compile(r"^(?:\d+\.\d*(?:[eE][-+]?\d+)?[fF]?|\.\d+[fF]?"
                        r"|\d+[eE][-+]?\d+[fF]?|\d+[fF])$")


def _split_params(params: str) -> list[str]:
    """A parameter list split at its top-level commas."""
    out, depth, cur = [], 0, ""
    for ch in params:
        depth += {"(": 1, "<": 1, "[": 1, ")": -1, ">": -1, "]": -1}.get(ch, 0)
        if ch == "," and depth == 0:
            out.append(cur)
            cur = ""
        else:
            cur += ch
    return [p for p in out + [cur] if p.strip()]


def _args(toks, open_idx: int) -> list[list]:
    """The argument token lists of the call whose ``(`` is at
    ``open_idx``."""
    end = _match(toks, open_idx, 1)
    out, cur, depth = [], [], 0
    for t in toks[open_idx + 1:end]:
        if t[0] in ("(", "["):
            depth += 1
        elif t[0] in (")", "]"):
            depth -= 1
        if t[0] == "," and depth == 0:
            out.append(cur)
            cur = []
        else:
            cur.append(t)
    return out + ([cur] if cur else [])


def _tokens(text: str) -> list[tuple[str, int]]:
    return [(m.group(0), m.start()) for m in _TOKEN_RE.finditer(text)]


def _match(toks, i, step):
    """Index of the bracket matching ``toks[i]`` (forward or backward)."""
    pairs = {"(": ")", "[": "]", ")": "(", "]": "["}
    depth = 0
    open_, close = toks[i][0], pairs[toks[i][0]]
    j = i
    while 0 <= j < len(toks):
        if toks[j][0] == open_:
            depth += 1
        elif toks[j][0] == close:
            depth -= 1
            if depth == 0:
                return j
        j += step
    return i


def _memo(method):
    """Cache a per-function analysis of :class:`_MulLint` by name."""
    def cached(self, name: str):
        key = (method.__name__, name)
        if key not in self._memo:
            self._memo[key] = method(self, name)
        return self._memo[key]
    return cached


class _MulLint:
    """The output-multiply lint over the functions of one source."""

    def __init__(self, sources: list[_Source]):
        self.funcs: dict[str, tuple[_Source, int, int, str, str]] = {}
        self.float_funcs: set[str] = set()
        self._memo: dict[tuple[str, str], object] = {}
        for src in sources:
            for name, spans in src.funcs.items():
                for a, b, params, ret in spans:
                    self.funcs[name] = (src, a, b, params, ret)
                    if re.search(r"\b(float|double)\b", ret.split("\n")[-1]):
                        self.float_funcs.add(name)

    @_memo
    def _floats(self, name: str) -> set[str]:
        src, a, b, params, _ = self.funcs[name]
        out = {m.group(1) for m in re.finditer(
            r"\b(?:float|double)\s+(?:&\s*)?(\w+)", params)}
        for m in re.finditer(r"\b(?:const\s+)?(?:float|double)\s+([^;()]+);",
                             src.text[a:b]):
            for part in m.group(1).split(","):
                nm = re.match(r"\s*&?\s*(\w+)", part)
                if nm:
                    out.add(nm.group(1))
        return out

    @_memo
    def _stmts(self, name: str) -> list:
        """The function's simple statements, without a leading ``if (...)``,
        ``for (...)``, ``while (...)`` or ``else``."""
        src, a, b, _, _ = self.funcs[name]
        toks = [(s, a + 1 + p) for s, p in _tokens(src.text[a + 1:b - 1])]
        out, cur = [], []
        for t in toks:
            if t[0] in (";", "{", "}"):
                while cur and cur[0][0] in ("if", "for", "while", "else",
                                            "constexpr"):
                    if cur[0][0] in ("else", "constexpr"):
                        cur = cur[1:]
                    elif len(cur) > 1 and cur[1][0] == "(":
                        cur = cur[_match(cur, 1, 1) + 1:]
                    else:
                        break
                if cur:
                    out.append(cur)
                cur = []
            else:
                cur.append(t)
        return out

    @_memo
    def _defs(self, name: str) -> dict[str, list[list]]:
        """Local name -> right-hand sides assigned to it (or to its
        elements); ``return`` values under ``"<return>"``."""
        out: dict[str, list[list]] = {}
        for st in self._stmts(name):
            words = [s for s, _ in st]
            if words and words[0] == "return":
                out.setdefault("<return>", []).append(st[1:])
                continue
            for k, w in enumerate(words):
                if w in ("=", "+=", "-=", "*=", "|=", "&=", "^=", "<<=", ">>="):
                    lhs = words[:k]
                    target = next((x for x in reversed(
                        [x for x in lhs if not x.startswith("[")])
                        if re.match(r"^[A-Za-z_]\w*$", x) and x not in
                        ("const", "uint32_t", "int32_t", "int", "float",
                         "double", "auto", "unsigned", "long")), None)
                    if "[" in lhs:
                        target = lhs[lhs.index("[") - 1]
                    if target:
                        out.setdefault(target, []).append(st[k + 1:])
                    break
        return out

    @_memo
    def _params(self, name: str) -> list[str]:
        _, _, _, params, _ = self.funcs[name]
        out = []
        for p in _split_params(params):
            m = re.search(r"(\w+)\s*(?:\)\s*)?(?:\[[^\]]*\]\s*)*$", p.strip())
            out.append(m.group(1) if m else "")
        return out

    @_memo
    def _outputs(self, name: str) -> set[str]:
        """Non-const pointer parameters, members of the launch arguments
        (``Args``), and the local pointers made from them."""
        _, _, _, params, _ = self.funcs[name]
        out = set()
        for p, pname in zip(_split_params(params), self._params(name)):
            if pname and "*" in p and "const" not in p:
                out.add(pname)
            if pname and re.search(r"\bArgs\b", p):
                out.add(pname)
        defs = self._defs(name)
        changed = True
        while changed:
            changed = False
            for local, rhss in defs.items():
                if local not in out and any(
                        t in out for rhs in rhss for t, _ in rhs):
                    src, a, b, _, _ = self.funcs[name]
                    if re.search(rf"\*\s*(?:__restrict__\s*)?{local}\b",
                                 src.text[a:b]):
                        out.add(local)
                        changed = True
        return out

    def _floatish(self, toks, floats) -> bool:
        for k, (t, _) in enumerate(toks):
            if _FLOAT_LIT.match(t) or t in floats:
                return True
            nxt = toks[k + 1][0] if k + 1 < len(toks) else ""
            if nxt == "(" and (_FLOAT_CALLS.match(t) or t in self.float_funcs):
                return True
            if t in ("float", "double"):
                return True
        return False

    def _multiplies(self, toks, func: str, seen: set, rounded: bool,
                    depth: int = 0) -> list[int]:
        """Source positions of float ``*`` in ``toks`` and in the
        definitions they read (locals, helper returns)."""
        if depth > 12:
            return []
        floats = self._floats(func)
        defs = self._defs(func)
        inside_round = [False] * len(toks)
        for k, (t, _) in enumerate(toks):
            if _ROUND_CALLS.match(t) and k + 1 < len(toks) and toks[k + 1][0] == "(":
                end = _match(toks, k + 1, 1)
                for q in range(k + 1, end + 1):
                    inside_round[q] = True
        hits: list[int] = []
        for k, (t, pos) in enumerate(toks):
            r = rounded or inside_round[k]
            if t == "*" and 0 < k < len(toks) - 1 and not r:
                prev, nxt = toks[k - 1][0], toks[k + 1][0]
                if (re.match(r"^[\w.]+$", prev) or prev in (")", "]")) and (
                        re.match(r"^[\w.]+$", nxt) or nxt in ("(", "-")):
                    lo = k - 1
                    if toks[lo][0] in (")", "]"):
                        lo = _match(toks, lo, -1)
                        if lo > 0 and re.match(r"^\w+$", toks[lo - 1][0]):
                            lo -= 1
                    hi = k + 1
                    if toks[hi][0] == "(":
                        hi = _match(toks, hi, 1)
                    elif hi + 1 < len(toks) and toks[hi + 1][0] in ("(", "["):
                        hi = _match(toks, hi + 1, 1)
                    if (self._floatish(toks[lo:k], floats)
                            or self._floatish(toks[k + 1:hi + 1], floats)):
                        hits.append(pos)
            if re.match(r"^[A-Za-z_]\w*$", t):
                key = (func, t, r)
                if t in defs and key not in seen:
                    seen.add(key)
                    for rhs in defs[t]:
                        hits += self._multiplies(rhs, func, seen, r, depth + 1)
                nxt = toks[k + 1][0] if k + 1 < len(toks) else ""
                if nxt == "(" and t in self.funcs and t != func and (
                        t, "<return>", r) not in seen:
                    seen.add((t, "<return>", r))
                    for rhs in self._defs(t).get("<return>", []):
                        hits += self._multiplies(rhs, t, seen, r, depth + 1)
        return hits

    def _direct_stores(self, name: str):
        """``(line, value tokens)`` of the element / ``*`` assignments to
        an output and the values of streaming-store calls in ``name``."""
        src = self.funcs[name][0]
        outs = self._outputs(name)
        for st in self._stmts(name):
            words = [s for s, _ in st]
            for k, w in enumerate(words):
                if w in ("=", "+=", "-=", "*=", "|=") and k > 0:
                    if words[0] == "*":
                        base = next((x for x in words[1:k] if re.match(
                            r"^[A-Za-z_]\w*$", x) and x not in (
                            "reinterpret_cast", "uint4", "uint2", "float4",
                            "int4", "const")), "")
                    else:
                        base = words[0]
                    if base in outs and ("[" in words[:k] or words[0] == "*"):
                        yield src.line_of(st[0][1]), st[k + 1:]
                    break
            for k, w in enumerate(words):
                if (w in _STORE_CALLS and k + 1 < len(words)
                        and words[k + 1] == "("):
                    args = _args(st, k + 1)
                    if len(args) > _STORE_CALLS[w]:
                        yield src.line_of(st[0][1]), args[_STORE_CALLS[w]]

    def _helper_calls(self, name: str):
        """``(line, callee, argument token lists)`` of calls in ``name`` to
        functions of the sources."""
        src = self.funcs[name][0]
        for st in self._stmts(name):
            for k, (t, pos) in enumerate(st):
                if (t in self.funcs and t != name and k + 1 < len(st)
                        and st[k + 1][0] in ("(", "<")):
                    j = k + 1
                    if st[j][0] == "<":  # explicit template arguments
                        depth = 0
                        while j < len(st):
                            depth += {"<": 1, ">": -1}.get(st[j][0], 0)
                            j += 1
                            if depth == 0:
                                break
                    if j < len(st) and st[j][0] == "(":
                        yield src.line_of(pos), t, _args(st, j)

    def _stored_params(self) -> dict[str, set[int]]:
        """Function -> indices of the parameters whose values it stores to
        an output (itself or through a helper), to a fixpoint."""
        stored: dict[str, set[int]] = {n: set() for n in self.funcs}
        changed = True
        while changed:
            changed = False
            for name in self.funcs:
                params = self._params(name)
                values = [v for _, v in self._direct_stores(name)]
                for _, callee, args in self._helper_calls(name):
                    values += [args[i] for i in stored[callee] if i < len(args)]
                names = {t for v in values for t, _ in v}
                got = {i for i, p in enumerate(params) if p and p in names}
                if not got <= stored[name]:
                    stored[name] |= got
                    changed = True
        return stored

    def stores(self):
        """``(source, function, statement line, value tokens)`` of every
        store to an output: an element or ``*`` assignment whose base is a
        non-const pointer parameter, a member of the launch arguments or a
        local pointer made from them; the value of a streaming-store call;
        and the arguments a helper (``store4``) stores."""
        stored = self._stored_params()
        for name, (src, *_rest) in self.funcs.items():
            for line, value in self._direct_stores(name):
                yield src, name, line, value
            for line, callee, args in self._helper_calls(name):
                for i in sorted(stored[callee]):
                    if i < len(args):
                        yield src, name, line, args[i]

    def lint(self):
        """``(source, function, line)`` of every store fed by a float
        multiply."""
        seen_lines = set()
        for src, func, line, value in self.stores():
            if (src.name, line) in seen_lines:
                continue
            if self._multiplies(value, func, set(), False):
                seen_lines.add((src.name, line))
                yield src, func, line


def _waivers(raw: str) -> dict[int, list[int]]:
    """Line -> waiver comment lines covering it (its own and the one
    below), for ``output-multiply``."""
    out: dict[int, list[int]] = {}
    for i, line in enumerate(raw.splitlines(), start=1):
        m = _WAIVE_RE.search(line)
        if m and "output-multiply" in m.group(1):
            out.setdefault(i, []).append(i)
            out.setdefault(i + 1, []).append(i)
    return out


def lint_cuda_sources(sources: list[_Source]) -> list[Finding]:
    """Output-multiply lint with its waivers and stale-waiver warnings."""
    findings = []
    used: set[tuple[str, int]] = set()
    waivers = {s.name: _waivers(s.raw) for s in sources}
    for src, func, line in _MulLint(sources).lint():
        hits = waivers[src.name].get(line, [])
        if hits:
            used.update((src.name, h) for h in hits)
            continue
        findings.append(Finding(
            _ANALYZER, "output-multiply",
            f"a float multiply feeds the store in {func}() — a plain `*` may "
            "contract into an FMA with a later add and round once where "
            "the plain version rounds twice",
            subject=func, file=f"src/repro_torch/kernels/csrc/{src.name}",
            line=line,
            suggestion="emit the integer plane and apply the float tail in "
                       "torch, or use __fmul_rn(__int2float_rn(x), y) "
                       "(// audit: waive(output-multiply) if deliberate)"))
    for src in sources:
        for line in sorted({c for cs in waivers[src.name].values() for c in cs}):
            if (src.name, line) not in used:
                findings.append(Finding(
                    _ANALYZER, "stale-waiver",
                    "// audit: waive(output-multiply) suppresses no "
                    "kernelspec finding — the waived code has moved or been "
                    "fixed", subject="output-multiply",
                    file=f"src/repro_torch/kernels/csrc/{src.name}", line=line,
                    severity="warning",
                    suggestion="delete the stale waiver comment"))
    return findings


# -- sites, tables, constants, launchers ----------------------------------------

def _check_sites(specs, sources: list[_Source]) -> list[Finding]:
    out: list[Finding] = []
    by_file = {s.name: s for s in sources}
    declared = {(s.source, s.function) for s in specs}
    launched = {(s.source, s.function, s.launch) for s in specs}
    globals_ = {(src.name, g): line for src in sources for g, line in src.globals()}
    sites = {(src.name, k, f): line for src in sources
             for k, f, line in src.launches()}
    for (file, fn), line in sorted(globals_.items()):
        if (file, fn) not in declared:
            out.append(Finding(
                _ANALYZER, "undeclared-kernel",
                f"__global__ {fn} has no KernelSpec — its bounds, coverage "
                "and shared memory are unverified",
                subject=fn, file=f"src/repro_torch/kernels/csrc/{file}",
                line=line,
                suggestion="declare every instantiation in "
                           "repro_torch.kernels.specs.KERNEL_SPECS"))
    for (file, fn, host), line in sorted(sites.items(), key=str):
        if (file, fn) in declared and (file, fn, host) not in launched:
            out.append(Finding(
                _ANALYZER, "undeclared-kernel",
                f"{fn} is launched from {host}() with no KernelSpec naming "
                "that launch site",
                subject=fn, file=f"src/repro_torch/kernels/csrc/{file}",
                line=line, suggestion="name the launch site in a spec"))
    for s in specs:
        if s.source in by_file and ((s.source, s.function) not in globals_ or
                                    (s.source, s.function, s.launch)
                                    not in sites):
            out.append(Finding(
                _ANALYZER, "stale-kernel-spec",
                f"KernelSpec {s.name!r} names {s.function} launched from "
                f"{s.launch}() in {s.source}, which no longer exists",
                subject=s.name, file="src/repro_torch/kernels/specs.py",
                suggestion="delete or re-point the spec"))
        elif s.source not in by_file:
            out.append(Finding(
                _ANALYZER, "stale-kernel-spec",
                f"KernelSpec {s.name!r} names the missing source {s.source}",
                subject=s.name, file="src/repro_torch/kernels/specs.py"))
    return out


def _check_tables(specs, sources: list[_Source]) -> list[Finding]:
    """The KernelInfo tables list exactly the specs, in id order."""
    attrs = next((s for s in sources if s.name == "attrs.cu"), None)
    if attrs is None:
        return []
    out = []
    tables: dict[str, list[str]] = {}
    for src in sources:
        entries = src.table()
        for name, fn in entries:
            if re.sub(r"\s+", "", name) != re.sub(r"\s+", "", fn):
                out.append(Finding(
                    _ANALYZER, "kernel-id-drift",
                    f"table entry {name!r} holds {fn}", subject=name,
                    file=f"src/repro_torch/kernels/csrc/{src.name}"))
        for m in re.finditer(r"const\s+KernelTable\s+(\w+)\s*=\s*\{\s*\w+\s*,"
                             r"\s*(\d+)\s*\}", src.text):
            tables[m.group(1)] = [n for n, _ in entries]
            if int(m.group(2)) != len(entries):
                out.append(Finding(
                    _ANALYZER, "kernel-id-drift",
                    f"{m.group(1)} counts {m.group(2)} entries but lists "
                    f"{len(entries)}", subject=m.group(1),
                    file=f"src/repro_torch/kernels/csrc/{src.name}"))
    order = re.findall(r"&hsz::(\w+)", attrs.text)
    ids = [n for t in order for n in tables.get(t, [])]
    names = [s.name for s in specs]
    for n in sorted(set(ids) - set(names)):
        out.append(Finding(
            _ANALYZER, "undeclared-kernel",
            f"instantiation {n} is in the library's table but has no "
            "KernelSpec", subject=n,
            file="src/repro_torch/kernels/csrc/attrs.cu"))
    for n in sorted(set(names) - set(ids)):
        out.append(Finding(
            _ANALYZER, "stale-kernel-spec",
            f"KernelSpec {n!r} is in no instantiation table of the library",
            subject=n, file="src/repro_torch/kernels/specs.py"))
    if not out and ids != names:
        out.append(Finding(
            _ANALYZER, "kernel-id-drift",
            "hsz_func_attrs's kernel ids (the tables in attrs.cu order) are "
            "not in the order of specs.KERNEL_IDS", subject="KERNEL_IDS",
            file="src/repro_torch/kernels/csrc/attrs.cu"))
    return out


def _check_constants(sources: list[_Source], constants: dict) -> list[Finding]:
    out = []
    for src in sources:
        want = constants.get(src.name)
        if want is None:
            continue
        got = src.constexprs({})
        for name, value in want.items():
            if got.get(name) != value:
                out.append(Finding(
                    _ANALYZER, "constexpr-drift",
                    f"the specs use {name} = {value} but {src.name} declares "
                    f"{got.get(name, 'no such constexpr')}",
                    subject=name, file=f"src/repro_torch/kernels/csrc/{src.name}",
                    suggestion="update kernels/specs.py CONSTANTS with the "
                               "source (and re-prove), or restore the source"))
    return out


def _check_smem_source(specs, sources: list[_Source]) -> list[Finding]:
    from ..kernels.specs import CONSTANTS, smem_bytes

    by_file = {s.name: s for s in sources}
    out = []
    for s in specs:
        src = by_file.get(s.source)
        if src is None or s.function not in src.funcs:
            continue
        got = src.shared_bytes(s.function, CONSTANTS.get(s.source, {}),
                               s.smem_arrays)
        want = smem_bytes(s)[0]
        if got != want:
            out.append(_finding(
                "smem-drift", s,
                f"the source's __shared__ arrays take {got} bytes but the "
                f"spec counts {want}",
                suggestion="update smem_static in kernels/specs.py"))
    return out


def _ctype_kind(t) -> str:
    import ctypes

    kinds = {ctypes.c_int: "int", ctypes.c_longlong: "long long",
             ctypes.c_void_p: "pointer"}
    return kinds.get(t, getattr(t, "__name__", str(t)))


def _c_type(param: str) -> str:
    if "*" in param:
        return "pointer"
    if re.search(r"\blong\s+long\b", param):
        return "long long"
    if re.search(r"\bint\b", param):
        return "int"
    return param.strip()


def prototypes(sources: list[_Source]) -> dict[str, tuple[str, ...]]:
    """``extern "C"`` launcher name -> parameter kinds."""
    out = {}
    for src in sources:
        for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)',
                             src.raw):
            params = [p for p in m.group(2).split(",") if p.strip()]
            out[m.group(1)] = tuple(_c_type(p) for p in params)
    return out


def check_signatures(signatures: dict, sources: list[_Source]) -> list[Finding]:
    """``build.SIGNATURES`` against the parsed prototypes."""
    protos = prototypes(sources)
    out = []
    for name in sorted(set(signatures) | set(protos)):
        want = protos.get(name)
        got = signatures.get(name)
        if want is None or got is None:
            out.append(Finding(
                _ANALYZER, "launcher-signature",
                f"{name} is {'in build.SIGNATURES' if want is None else 'an extern \"C\" launcher'} "
                f"but not {'a launcher of csrc' if want is None else 'in build.SIGNATURES'}",
                subject=name, file="src/repro_torch/kernels/build.py"))
            continue
        kinds = tuple(_ctype_kind(t) for t in got)
        if kinds != want:
            out.append(Finding(
                _ANALYZER, "launcher-signature",
                f"{name}: build.SIGNATURES passes {list(kinds)} but the "
                f"prototype takes {list(want)} — ctypes would pass the "
                "arguments with the wrong widths or order and corrupt memory",
                subject=name, file="src/repro_torch/kernels/build.py",
                suggestion="make the argtypes match the prototype"))
    return out


def load_sources(csrc: str | Path) -> list[_Source]:
    csrc = Path(csrc)
    return [_Source(p) for p in sorted(csrc.iterdir())
            if p.suffix in (".cu", ".cuh")]


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def analyze_kernel_specs(env: Envelope = DEFAULT_ENVELOPE, *, specs=None,
                         csrc: str | Path | None = None, constants=None,
                         signatures=None, pad: int | None = None
                         ) -> list[Finding]:
    """Run the launch-grid verifier against the specs and the sources.

    ``specs`` / ``csrc`` / ``constants`` / ``signatures`` / ``pad`` are
    injectable for the sabotage fixtures; the defaults audit the live
    package.  With a ``csrc`` of its own, the constant and signature checks
    run only when their tables are given too.  ``env`` is accepted for the
    runner's uniform call: a block's footprint is a constant per
    instantiation, with no field-size term.
    """
    del env
    from ..kernels import build
    from ..kernels import specs as kspecs

    if csrc is None:
        csrc = build.CSRC
        constants = kspecs.CONSTANTS if constants is None else constants
        signatures = build.SIGNATURES if signatures is None else signatures
    if specs is None:
        specs = kspecs.KERNEL_SPECS
    sources = load_sources(csrc)

    findings: list[Finding] = []
    for spec in specs:
        consts = kspecs.CONSTANTS.get(spec.source, {})
        findings.extend(check_spec(spec, consts))
        findings.extend(_check_launches(spec))
    stagings = {s.staging for s in specs}
    if "unpack" in stagings:
        findings.extend(check_unpack_lemma(pad))
    if "lorenzo" in stagings:
        findings.extend(check_lorenzo_staging())
    if "blockmean" in stagings:
        findings.extend(check_blockmean_staging())
    findings.extend(lint_cuda_sources(sources))
    findings.extend(_check_sites(specs, sources))
    findings.extend(_check_tables(specs, sources))
    findings.extend(_check_smem_source(specs, sources))
    if constants:
        findings.extend(_check_constants(sources, constants))
    if signatures is not None:
        findings.extend(check_signatures(signatures, sources))
    return findings

