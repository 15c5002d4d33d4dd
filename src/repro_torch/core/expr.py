"""Expression DAG: cross-field derived operators over compressed data.

The op-set pipeline (:func:`repro_torch.core.oplib.compute`) lowers *one op
set over one field* onto a shared stage reconstruction.  Real derived
quantities — vorticity from (u, v), ensemble deltas — combine the results of
ops over *several* compressed fields.  This module generalizes the op set to
a small expression language:

* **Leaves** (:class:`Leaf`) name compressed inputs: a store field id, a raw
  :class:`~repro_torch.core.stages.Compressed` /
  :class:`~repro_torch.core.stages.Encoded` container, a component bundle
  (tuple of fields/ids, for ``divergence``/``curl``), or a
  ``repro_torch.stream.TemporalField``.
* **Op nodes** (:class:`Op`) apply one registered
  :class:`~repro_torch.core.oplib.OpSpec` to a leaf.  Ops apply to leaves
  *only* — they lower against the leaf's stage prelude; derived values are
  combined, not re-compressed.
* **Combinators** (:class:`Add`/:class:`Sub`/:class:`Scale`) form pointwise
  float arithmetic between op results (``a + b``, ``a - b``, ``alpha * a``
  with a static Python scalar).

:func:`analyze` validates a batch of root expressions (arity vs leaf kind,
component-count checks, duplicate ids inside a bundle, cycle detection,
temporal/spatial consumer consistency) and
compiles them into an :class:`ExprProgram`: leaves deduplicated into
*slots*, a canonical structural hash for program-cache keys (``add`` is
canonically commuted, so ``x + y`` and ``y + x`` share one program — IEEE
addition commutes bitwise), and the connected components the planner assigns
joint stages to.

:func:`lower` evaluates a bound program: every leaf slot gets exactly ONE
:class:`~repro_torch.core.oplib.StageContext` prelude shared by all consuming
ops, op nodes are CSE'd on their canonical serialization and lowered by the
rule :func:`~repro_torch.core.oplib.compute` would select, and combinators
are pointwise float tails — so every root is bit-identical to composing the
single-op results at the same stage.  Temporal op values (``tdelta``,
``tmean``, ``tmin``, ``tmax``, ``tstd`` over a stream) are summarized
outside the spatial program and join it through ``precomputed``.
"""
from __future__ import annotations

import hashlib
from collections.abc import Callable, Sequence
from dataclasses import dataclass
from typing import Any

from . import oplib
from . import region as R
from .stages import Compressed, Encoded, Scheme, Stage

Field = Compressed | Encoded

__all__ = [
    "Expr", "Leaf", "Op", "Add", "Sub", "Scale", "ExprProgram",
    "leaf", "op", "add", "sub", "scale", "analyze", "lower",
    "leaf_closure", "vector_closures", "validate_bound",
    "mean", "std", "derivative", "gradient", "laplacian",
    "divergence", "curl", "tdelta", "tmean", "tmin", "tmax", "tstd",
]


# ===========================================================================
# nodes
# ===========================================================================

class Expr:
    """Base class of expression nodes.

    Nodes are immutable after construction (so a DAG, once built, cannot be
    mutated into a cycle or out of sync with its analyzed program) and
    support operator sugar: ``a + b``, ``a - b``, ``2.0 * a``, ``-a``.
    """

    __slots__ = ("_frozen",)

    def _freeze(self) -> None:
        object.__setattr__(self, "_frozen", True)

    def __setattr__(self, name, value):
        if getattr(self, "_frozen", False):
            raise AttributeError(
                "expression nodes are immutable; build a new expression "
                "instead of mutating this one")
        object.__setattr__(self, name, value)

    def __add__(self, other):
        return Add(self, other)

    def __sub__(self, other):
        return Sub(self, other)

    def __mul__(self, alpha):
        return Scale(self, alpha)

    __rmul__ = __mul__

    def __neg__(self):
        return Scale(self, -1.0)


def _source_key(src) -> tuple:
    return ("id", src) if isinstance(src, str) else ("obj", id(src))


class Leaf(Expr):
    """A compressed input: field id, container, or component bundle.

    A string id is resolved against the query's store at execution time.  A
    tuple/list bundles vector components for ``divergence``/``curl`` (each
    component a field or id; duplicate ids are rejected — a vector field's
    components are distinct physical quantities).  A ``TemporalField``
    (anything with ``layout_sig``) is a ``"temporal"`` leaf, consumed by the
    temporal ops.  A bare id's kind (spatial field vs temporal stream) is
    fixed by the ops consuming it.
    """

    __slots__ = ("source",)

    def __init__(self, source):
        if isinstance(source, (tuple, list)):
            comps = tuple(source)
            if not comps:
                raise ValueError("empty component bundle")
            for c in comps:
                if not isinstance(c, (str, Compressed, Encoded)):
                    raise TypeError(
                        f"bundle components are Compressed/Encoded fields or "
                        f"store ids; got {type(c).__name__}")
            named = [c for c in comps if isinstance(c, str)]
            if len(set(named)) != len(named):
                raise ValueError(
                    f"duplicate field ids in component bundle: "
                    f"{tuple(c if isinstance(c, str) else '<field>' for c in comps)}")
            self.source = comps
        elif isinstance(source, (str, Compressed, Encoded)):
            self.source = source
        elif hasattr(source, "layout_sig"):  # TemporalField (repro_torch.stream)
            self.source = source
        else:
            raise TypeError(
                f"a leaf is a field id, a Compressed/Encoded field, a "
                f"component bundle, or a TemporalField; got "
                f"{type(source).__name__}")
        self._freeze()

    @property
    def kind(self) -> str:
        """``"vector"`` | ``"field"`` | ``"temporal"`` | ``"id"``."""
        if isinstance(self.source, tuple):
            return "vector"
        if isinstance(self.source, str):
            return "id"
        if hasattr(self.source, "layout_sig"):
            return "temporal"
        return "field"

    @property
    def key(self) -> tuple:
        """Binding key: equal keys share one slot (one prelude) in a
        program.  Ids compare by name; raw containers by object identity."""
        if self.kind == "vector":
            return ("vec",) + tuple(_source_key(c) for c in self.source)
        return _source_key(self.source)


class Op(Expr):
    """One registered operation applied to a leaf.

    ``axis`` matters only for axis-bearing ops (``derivative``); it is
    normalized to 0 otherwise so structurally identical applications share
    one canonical form.
    """

    __slots__ = ("name", "operand", "axis")

    def __init__(self, name: str, operand, axis: int = 0):
        if name not in oplib._ALL_OPS:
            raise ValueError(
                f"unknown operation {name!r}; expected one of "
                f"{tuple(oplib._ALL_OPS)}")
        if not isinstance(operand, Expr):
            operand = Leaf(operand)
        if not isinstance(operand, Leaf):
            raise TypeError(
                f"{name} lowers against a compressed leaf's stage prelude; "
                "it cannot consume a derived expression — combine op results "
                "with add/sub/scale instead")
        spec = oplib._ALL_OPS[name]
        kind = operand.kind
        if spec.arity == "vector":
            if kind != "vector":
                raise TypeError(
                    f"vector op {name!r} takes a component bundle; got a "
                    f"{kind} leaf — pass a tuple of component fields/ids")
            spec.component_axes(len(operand.source))  # validates e.g. curl
        elif spec.arity == "temporal":
            if kind not in ("temporal", "id"):
                raise TypeError(
                    f"temporal op {name!r} runs over a TemporalField stream "
                    f"(or its store id); got a {kind} leaf")
        elif kind not in ("field", "id"):
            raise TypeError(
                f"{name} takes a single Compressed/Encoded field (or its "
                f"id); got a {kind} leaf")
        self.name = name
        self.operand = operand
        self.axis = int(axis) if spec.needs_axis else 0
        self._freeze()

    @property
    def spec(self) -> oplib.OpSpec:
        return oplib._ALL_OPS[self.name]

    @property
    def tuple_valued(self) -> bool:
        """Does this node yield a tuple of components (``gradient``, 3-D
        ``curl``)?  Tuple-valued nodes can be roots but not combinator
        operands."""
        if self.name == "gradient":
            return True
        return self.name == "curl" and len(self.operand.source) == 3


def _value_operand(node, what: str) -> Expr:
    if not isinstance(node, Expr):
        raise TypeError(
            f"{what} combines expressions; got {type(node).__name__} "
            "(apply an op to a field first)")
    if isinstance(node, Leaf):
        raise TypeError(
            f"a leaf has no value to {what}; apply an op to it first "
            "(leaves only feed ops)")
    if isinstance(node, Op) and node.tuple_valued:
        raise TypeError(
            f"{node.name} yields a tuple of components; combinators take "
            "array-valued expressions (combine per-axis derivative nodes "
            "instead)")
    return node


class Add(Expr):
    """Pointwise sum of two expression values (canonically commuted)."""

    __slots__ = ("a", "b")

    def __init__(self, a, b):
        self.a = _value_operand(a, "add")
        self.b = _value_operand(b, "add")
        self._freeze()


class Sub(Expr):
    """Pointwise difference ``a - b`` of two expression values."""

    __slots__ = ("a", "b")

    def __init__(self, a, b):
        self.a = _value_operand(a, "sub")
        self.b = _value_operand(b, "sub")
        self._freeze()


class Scale(Expr):
    """Pointwise scaling by a *static* Python scalar (part of the program's
    structural identity, not an input)."""

    __slots__ = ("x", "alpha")

    def __init__(self, x, alpha):
        self.x = _value_operand(x, "scale")
        if isinstance(alpha, Expr) or isinstance(alpha, bool) \
                or not isinstance(alpha, (int, float)):
            raise TypeError(
                f"scale takes a static Python scalar, got "
                f"{type(alpha).__name__}")
        self.alpha = float(alpha)
        self._freeze()


# -- builders ---------------------------------------------------------------

def leaf(source) -> Leaf:
    """Wrap a field / id / bundle as a :class:`Leaf` (idempotent)."""
    return source if isinstance(source, Leaf) else Leaf(source)


def op(name: str, operand, *, axis: int = 0) -> Op:
    """Apply registered op ``name`` to a leaf (fields auto-wrap)."""
    return Op(name, operand, axis=axis)


def add(a, b) -> Add:
    return Add(a, b)


def sub(a, b) -> Sub:
    return Sub(a, b)


def scale(x, alpha) -> Scale:
    return Scale(x, alpha)


def mean(x) -> Op:
    return Op("mean", x)


def std(x) -> Op:
    return Op("std", x)


def derivative(x, axis: int = 0) -> Op:
    return Op("derivative", x, axis=axis)


def gradient(x) -> Op:
    return Op("gradient", x)


def laplacian(x) -> Op:
    return Op("laplacian", x)


def divergence(components) -> Op:
    return Op("divergence", components)


def curl(components) -> Op:
    return Op("curl", components)


def tdelta(x) -> Op:
    return Op("tdelta", x)


def tmean(x) -> Op:
    return Op("tmean", x)


def tmin(x) -> Op:
    return Op("tmin", x)


def tmax(x) -> Op:
    return Op("tmax", x)


def tstd(x) -> Op:
    return Op("tstd", x)


# ===========================================================================
# traversal / canonicalization
# ===========================================================================

def _children(node: Expr) -> tuple[Expr, ...]:
    if isinstance(node, Op):
        return (node.operand,)
    if isinstance(node, (Add, Sub)):
        return (node.a, node.b)
    if isinstance(node, Scale):
        return (node.x,)
    return ()


def _postorder(roots: Sequence[Expr],
               child_order: Callable | None = None) -> list[Expr]:
    """Iterative post-order over the DAG (each node once), with cycle
    detection.  Nodes are immutable, so a cycle cannot normally be built —
    the check guards against ``object.__setattr__`` surgery and keeps the
    failure mode a clear error instead of an endless walk."""
    order = child_order or _children
    state: dict[int, int] = {}  # id -> 0 visiting, 1 done
    out: list[Expr] = []
    stack: list[tuple[Expr, bool]] = [(r, False) for r in reversed(roots)]
    while stack:
        node, processed = stack.pop()
        st = state.get(id(node))
        if processed:
            state[id(node)] = 1
            out.append(node)
            continue
        if st == 1:
            continue
        if st == 0:
            raise ValueError("expression DAG contains a cycle")
        state[id(node)] = 0
        stack.append((node, True))
        for ch in reversed(order(node)):
            cst = state.get(id(ch))
            if cst == 0:
                raise ValueError("expression DAG contains a cycle")
            if cst != 1:
                stack.append((ch, False))
    return out


def _content_sigs(roots: Sequence[Expr]) -> dict[int, tuple]:
    """Binding-aware structural signature per node — used only to pick the
    canonical ``add`` child order, so ``x + y`` and ``y + x`` canonicalize
    to one slot assignment (and hence one structural hash)."""
    sigs: dict[int, tuple] = {}
    for node in _postorder(roots):
        if id(node) in sigs:
            continue
        if isinstance(node, Leaf):
            s: tuple = ("L",) + node.key
        elif isinstance(node, Op):
            s = ("O", node.name, node.axis, sigs[id(node.operand)])
        elif isinstance(node, Add):
            a, b = sigs[id(node.a)], sigs[id(node.b)]
            s = ("A",) + tuple(sorted((a, b), key=repr))
        elif isinstance(node, Sub):
            s = ("S", sigs[id(node.a)], sigs[id(node.b)])
        else:
            s = ("C", node.alpha, sigs[id(node.x)])
        sigs[id(node)] = s
    return sigs


@dataclass(frozen=True)
class ExprProgram:
    """One analyzed batch of root expressions, ready to plan and lower.

    ``leaves`` are the deduplicated input slots (equal :attr:`Leaf.key` →
    one slot → one prelude); ``key`` is the canonical structural hash (leaf
    identities abstracted to slot indices) that keys cached programs
    together with the per-slot layout signatures.  ``leaf_component`` /
    ``root_component`` partition the DAG into connected components — the
    planner's joint-stage unit: leaves joined by a combinator must share a
    stage-compatible plan, while independent roots plan independently.
    """

    roots: tuple[Expr, ...]
    leaves: tuple[Leaf, ...]
    leaf_keys: tuple[tuple, ...]
    key: str
    serials: dict[int, str]            # id(node) -> canonical serialization
    op_nodes: tuple[Op, ...]           # unique op nodes, canonical order
    op_slots: tuple[int, ...]          # operand slot per op node
    leaf_component: tuple[int, ...]
    root_component: tuple[int, ...]
    n_components: int

    def slot_of(self, lf: Leaf) -> int:
        return self.leaf_keys.index(lf.key)

    def serial(self, node: Expr) -> str:
        return self.serials[id(node)]

    def component_ops(self, comp: int) -> tuple[tuple[str, int, int], ...]:
        """Unique ``(op name, axis, leaf slot)`` applications inside one
        connected component — the planner's feasibility/cost unit."""
        return tuple((n.name, n.axis, s)
                     for n, s in zip(self.op_nodes, self.op_slots)
                     if self.leaf_component[s] == comp)

    def leaf_consumers(self, slot: int) -> tuple[tuple[str, int], ...]:
        """Unique ``(op name, axis)`` pairs consuming one leaf slot — the
        closure-join input."""
        return tuple((n.name, n.axis)
                     for n, s in zip(self.op_nodes, self.op_slots)
                     if s == slot)

    @property
    def temporal_nodes(self) -> tuple[Op, ...]:
        return tuple(n for n in self.op_nodes if n.spec.arity == "temporal")

    def leaf_is_temporal(self, slot: int) -> bool:
        return any(oplib._ALL_OPS[n].arity == "temporal"
                   for n, _ in self.leaf_consumers(slot))


def analyze(roots: Sequence[Expr]) -> ExprProgram:
    """Validate root expressions and build their canonical program.

    Raises on: non-expression / bare-leaf roots, cycles, a leaf consumed by
    both temporal and spatial ops (a stream cannot also be a field), and any
    constructor-level violation latent in the DAG.  The program key is the
    reference's for the same DAG (the same serialization, hashed alike).
    """
    roots = tuple(roots)
    if not roots:
        raise ValueError("empty expression batch")
    for r in roots:
        if not isinstance(r, Expr):
            raise TypeError(
                f"expressions are Expr nodes; got {type(r).__name__}")
        if isinstance(r, Leaf):
            raise TypeError(
                "a bare leaf is not a query — apply an op to it "
                "(e.g. expr.mean(leaf))")
    sigs = _content_sigs(roots)  # also the cycle check

    def canonical_children(node: Expr) -> tuple[Expr, ...]:
        if isinstance(node, Add):
            return tuple(sorted((node.a, node.b),
                                key=lambda n: repr(sigs[id(n)])))
        return _children(node)

    order = _postorder(roots, canonical_children)

    slot_by_key: dict[tuple, int] = {}
    leaves: list[Leaf] = []
    serials: dict[int, str] = {}
    op_nodes: list[Op] = []
    op_slots: list[int] = []
    seen_ops: set[str] = set()
    for node in order:
        if isinstance(node, Leaf):
            k = node.key
            if k not in slot_by_key:
                slot_by_key[k] = len(leaves)
                leaves.append(node)
            serials[id(node)] = f"L{slot_by_key[k]}"
        elif isinstance(node, Op):
            s = f"{node.name}[{node.axis}]({serials[id(node.operand)]})"
            serials[id(node)] = s
            if s not in seen_ops:  # CSE: one postlude per distinct application
                seen_ops.add(s)
                op_nodes.append(node)
                op_slots.append(slot_by_key[node.operand.key])
        elif isinstance(node, Add):
            ca, cb = canonical_children(node)
            serials[id(node)] = f"add({serials[id(ca)]},{serials[id(cb)]})"
        elif isinstance(node, Sub):  # sub does not commute
            serials[id(node)] = (f"sub({serials[id(node.a)]},"
                                 f"{serials[id(node.b)]})")
        else:
            serials[id(node)] = f"scale({node.alpha!r},{serials[id(node.x)]})"

    # a slot consumed by both temporal and spatial ops can never be bound
    for slot in range(len(leaves)):
        arities = {n.spec.arity for n, s in zip(op_nodes, op_slots)
                   if s == slot}
        if "temporal" in arities and len(arities) > 1:
            raise TypeError(
                f"leaf {leaves[slot].key} is consumed by both temporal and "
                "spatial ops; a TemporalField stream answers temporal ops "
                "only (register the concatenated field separately for "
                "spatial analytics)")

    # connected components over leaf slots: every root unions its slots
    parent = list(range(len(leaves)))

    def find(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    root_slots: list[list[int]] = []
    for r in roots:
        slots = sorted({slot_by_key[n.key] for n in _postorder([r])
                        if isinstance(n, Leaf)})
        root_slots.append(slots)
        for s in slots[1:]:
            parent[find(slots[0])] = find(s)

    comp_ids: dict[int, int] = {}
    leaf_component = []
    for slot in range(len(leaves)):
        rep = find(slot)
        if rep not in comp_ids:
            comp_ids[rep] = len(comp_ids)
        leaf_component.append(comp_ids[rep])
    root_component = tuple(leaf_component[slots[0]] for slots in root_slots)

    digest = hashlib.sha256(
        ";".join(serials[id(r)] for r in roots).encode()).hexdigest()[:16]
    return ExprProgram(
        roots=roots, leaves=tuple(leaves),
        leaf_keys=tuple(lf.key for lf in leaves), key=digest,
        serials=serials, op_nodes=tuple(op_nodes), op_slots=tuple(op_slots),
        leaf_component=tuple(leaf_component), root_component=root_component,
        n_components=len(comp_ids))


# ===========================================================================
# closures (region dependency joins across all consumers of a leaf)
# ===========================================================================

def leaf_closure(program: ExprProgram, slot: int, scheme: Scheme,
                 stage: Stage) -> R.Closure:
    """Joined region closure over every (field-arity) consumer of a leaf —
    the one gather the slot's shared prelude reconstructs, hence the
    materialization key a store seed must match."""
    cons = program.leaf_consumers(slot)
    return oplib.join_closures(
        [oplib.OPS[n].closure(Scheme(scheme), Stage(stage), ax)
         for n, ax in cons])


def vector_closures(program: ExprProgram, slot: int,
                    schemes: Sequence[Scheme],
                    stage: Stage) -> tuple[R.Closure, ...]:
    """Per-component joined closures of a bundle leaf across every vector
    op consuming it (mirrors :func:`repro_torch.core.oplib.
    component_closures`, but joined over the *expression's* consumer set)."""
    stage = Stage(stage)
    axes_per_comp = [set() for _ in schemes]
    for name, _ in program.leaf_consumers(slot):
        for i, axes in enumerate(
                oplib.OPS[name].component_axes(len(schemes))):
            axes_per_comp[i].update(axes)
    return tuple(
        oplib.join_closures([R.op_closure(Scheme(s), "derivative", stage, a)
                             for a in sorted(axes)])
        for s, axes in zip(schemes, axes_per_comp))


# ===========================================================================
# bound validation (shape compatibility) and evaluation
# ===========================================================================

def _window_shape(shape: tuple[int, ...], region) -> tuple[int, ...]:
    if region is None:
        return tuple(shape)
    norm = R.normalize_region(region, shape)
    return tuple(e - s for s, e in norm)


def validate_bound(program: ExprProgram, bindings: Sequence,
                   region=None) -> None:
    """Host-side layout check of a *bound* program: combinator operands must
    agree in result shape (statistics are scalars and broadcast; stencil and
    temporal results must match elementwise).  Catches e.g. vorticity from
    differently-shaped u and v before any device work."""
    shapes: dict[str, tuple[int, ...] | None] = {}

    def op_shape(node: Op) -> tuple[int, ...] | None:
        if node.spec.category == "statistic":
            return None  # scalar: broadcasts against anything
        b = bindings[program.slot_of(node.operand)]
        if node.spec.arity == "temporal":
            return _window_shape(tuple(b.shape), region)
        base = b[0] if isinstance(b, tuple) else b
        w = _window_shape(tuple(base.shape), region)
        return tuple(n - 2 for n in w)  # stencils crop the interior

    for node in _postorder(program.roots):
        s = program.serial(node)
        if s in shapes:
            continue
        if isinstance(node, Leaf):
            shapes[s] = None
        elif isinstance(node, Op):
            shapes[s] = op_shape(node)
        elif isinstance(node, (Add, Sub)):
            sa = shapes[program.serial(node.a)]
            sb = shapes[program.serial(node.b)]
            if sa is not None and sb is not None and sa != sb:
                raise ValueError(
                    f"cannot combine results of shapes {sa} and {sb}; "
                    "combinator operands must agree elementwise "
                    "(statistics broadcast)")
            shapes[s] = sa if sa is not None else sb
        else:
            shapes[s] = shapes[program.serial(node.x)]


def lower(program: ExprProgram, bindings: Sequence,
          stages: Sequence[Stage], *, region=None,
          seeds: Sequence | None = None,
          precomputed: dict[str, Any] | None = None) -> tuple:
    """Evaluate a bound program: one shared prelude per leaf slot.

    ``bindings[slot]`` is the resolved field (or component tuple) for each
    leaf slot; ``stages[comp]`` is the joint stage of each connected
    component; ``seeds[slot]`` optionally supplies the slot's resident
    ``MaterializedStage`` (a tuple for bundle slots).  ``precomputed`` maps
    canonical node serializations to values computed outside the program:
    every temporal op node's value arrives there (its slot's binding may be
    ``None``), summarized by the engine / store machinery.  Every field op runs
    the rule :func:`~repro_torch.core.oplib.compute` selects for its cell
    (the fused rule where it covers), so each root is bit-identical to
    composing the corresponding single-op results at the same stage.
    """
    seeds = list(seeds) if seeds is not None else [None] * len(bindings)
    ctxs: dict[int, Any] = {}

    def ctx_for(slot: int):
        if slot not in ctxs:
            lf = program.leaves[slot]
            b = bindings[slot]
            if b is None:
                raise ValueError(f"leaf slot {slot} ({lf.key}) is unbound")
            stage = Stage(stages[program.leaf_component[slot]])
            if isinstance(b, tuple):
                schemes = [c.scheme for c in b]
                cls = vector_closures(program, slot, schemes, stage)
                sd = seeds[slot] if seeds[slot] is not None else (None,) * len(b)
                ctxs[slot] = tuple(
                    oplib.StageContext(c, stage, region, cl, seed=s)
                    for c, cl, s in zip(b, cls, sd))
            else:
                cl = leaf_closure(program, slot, b.scheme, stage)
                ctxs[slot] = oplib.StageContext(b, stage, region, cl,
                                                seed=seeds[slot])
        return ctxs[slot]

    def eval_op(node: Op):
        spec = node.spec
        slot = program.slot_of(node.operand)
        stage = Stage(stages[program.leaf_component[slot]])
        if spec.arity == "temporal":
            raise ValueError(
                f"temporal node {program.serial(node)} has no precomputed "
                "value; temporal op results are summarized outside the "
                "spatial program (see repro_torch.analytics.query / "
                "oplib.compute_exprs)")
        if spec.arity == "vector":
            cs = ctx_for(slot)
            for c in cs:
                oplib._check_feasible(spec, c.scheme, stage)
            return spec.lower_vector(cs, node.axis)
        ctx = ctx_for(slot)
        oplib._check_feasible(spec, ctx.scheme, stage)
        rule = oplib.select_rule(spec, stage, oplib.family_of(ctx.scheme), ctx)
        return rule(ctx, node.axis)

    memo: dict[str, Any] = dict(precomputed or {})
    for node in _postorder(program.roots):
        s = program.serial(node)
        if s in memo or isinstance(node, Leaf):
            continue
        if isinstance(node, Op):
            memo[s] = eval_op(node)
        elif isinstance(node, Add):
            memo[s] = memo[program.serial(node.a)] + memo[program.serial(node.b)]
        elif isinstance(node, Sub):
            memo[s] = memo[program.serial(node.a)] - memo[program.serial(node.b)]
        else:
            memo[s] = memo[program.serial(node.x)] * node.alpha
    return tuple(memo[program.serial(r)] for r in program.roots)
