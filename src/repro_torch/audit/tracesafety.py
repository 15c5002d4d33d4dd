"""Analyzer (3): host-sync lint of the query path.

PyTorch runs eagerly, so nothing is traced and no trace can fail.  What the
reference's trace-safety lint protects still matters: a query is one
dispatch of device work with no round trip to the host
(``analytics/engine.py``'s promise).  A host sync inside a lowering rule or
the code that calls the lowering stalls the stream on every query — the
device drains, the host waits, and the next kernel launches late — and
nothing in a test's results shows it.  This AST pass over ``core/``, ``analytics/``,
``stream/``, ``store/``, ``kernels/``, ``comm/`` and ``shard/`` finds them.

What counts as query-path scope
-------------------------------
* operator lowering rules: functions whose first parameter is ``ctx`` /
  ``ctxs`` (the :class:`~repro_torch.core.oplib.OpSpec` rule convention);
* the ``fn`` of every :class:`~repro_torch.core.fused.FusedRule`, also when
  it reaches ``FusedRule`` through a module helper that forwards it;
* every function (or lambda) that calls a lowering entry point
  (:data:`_LOWERING_CALLS`: ``oplib.compute``, ``oplib.StageContext``,
  ``oplib.summarize_slab``, ``decode_device``, ``expr.lower``) — the
  engine's and the shard layer's batched calls among them.

Nested ``def``\\ s and lambdas inside a root are linted with it.

What is flagged
---------------
* ``host-sync`` — ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()``
  and ``.to("cpu")`` anywhere in scope; ``float()`` / ``int()`` /
  ``bool()`` whose argument is not provably static (shapes, ``ndim``,
  dtypes, devices, ``numel()``, ``len``, constants are exempt);
  ``np.asarray`` / ``np.array`` on non-static values; *stringification* of
  tensor-derived values — f-string interpolation, ``str(x)``,
  ``format(x)`` and ``"...".format(x)`` all read the tensor back to the
  host; static interpolations (``f"{x.shape}"``) stay legal.
* ``tracer-branch`` (the reference's name, kept) — ``if`` / ``while`` /
  ternary tests, ``assert`` and ``and`` / ``or`` operands that reference a
  value the local dataflow marks *tensor-derived*: produced by a
  ``torch.*`` call, a method of a tensor-derived value, or a
  tensor-annotated parameter.  Each is ``Tensor.__bool__``, a sync.
  Branches on static structure (``ctx.plan is None``, ``scheme.is_nd``,
  ``x.ndim == 2``) are legal and not flagged.

Waivers
-------
A deliberate exception is waived with a comment on the same line or the
line above::

    x = arr.item()  # audit: waive(host-sync) <why this is safe>

A waiver that suppresses nothing is reported at *warning* severity
(``stale-waiver``), which never fails the audit.  This pass owns waivers
naming ``host-sync`` / ``tracer-branch``; other analyzers' vocabularies
(``output-multiply``, ``invariant(...)``) are staled by their own passes.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from .findings import Finding

_ANALYZER = "trace"

#: attribute names that read static structure, never tensor data.
_STATIC_ATTRS = frozenset({
    "shape", "ndim", "dtype", "device", "is_cuda", "itemsize", "name",
})
#: methods whose result is static structure (``x.numel()``, ``x.dim()``).
_STATIC_METHODS = frozenset({"numel", "dim", "size", "element_size"})
_CAST_CALLS = frozenset({"float", "int", "bool"})
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_NUMPY_NAMES = frozenset({"np", "numpy", "onp"})
_TENSOR_ANNOTATIONS = re.compile(r"\b(torch\s*\.\s*Tensor|Tensor)\b")
_TENSOR_MODULES = frozenset({"torch"})
_WAIVE_RE = re.compile(r"#\s*audit:\s*waive\(([a-z\-,\s]+)\)")
# Exact dotted callees that enter the kernel-switched lowering layer: a
# function calling one of them is query-path code.  Deliberately exact
# names: ``oplib.TemporalSummary`` (a plain container) is not a lowering.
_LOWERING_CALLS = frozenset({
    "oplib.compute", "oplib.StageContext", "oplib.select_rule",
    "oplib.summarize_slab", "encode.decode_device",
    "encode_mod.decode_device", "expr_mod.lower", "expr.lower",
})

#: the invariant names this pass owns waivers for.
_OWNED_WAIVERS = frozenset({"host-sync", "tracer-branch"})

_DEFAULT_ROOTS = ("core", "analytics", "stream", "store", "kernels",
                  "comm", "shard")


def _waivers(source: str) -> dict[int, set[tuple[int, str]]]:
    """Line → waiver declarations ``(comment_line, invariant)``; a waiver
    covers its own line and the one below (comment-above style)."""
    out: dict[int, set[tuple[int, str]]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _WAIVE_RE.search(line)
        if m:
            names = {w.strip() for w in m.group(1).split(",") if w.strip()}
            for name in names:
                out.setdefault(i, set()).add((i, name))
                out.setdefault(i + 1, set()).add((i, name))
    return out


def _dotted(node: ast.AST) -> str | None:
    """'a.b.c' for a pure attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_static_expr(node: ast.AST) -> bool:
    """Provably static: constants, shapes / dtypes / devices, ``numel()``,
    ``len()``, and arithmetic / subscripts thereof."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Attribute):
        n = node
        while isinstance(n, ast.Attribute):
            if n.attr in _STATIC_ATTRS:
                return True
            n = n.value
        return False
    if isinstance(node, ast.Subscript):
        return _is_static_expr(node.value)
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id == "len":
            return True
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _STATIC_METHODS):
            return True
        if isinstance(node.func, ast.Name) and node.func.id in _CAST_CALLS:
            return all(_is_static_expr(a) for a in node.args)
        return False
    if isinstance(node, ast.BinOp):
        return _is_static_expr(node.left) and _is_static_expr(node.right)
    if isinstance(node, ast.UnaryOp):
        return _is_static_expr(node.operand)
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(_is_static_expr(e) for e in node.elts)
    return False


def _tensor_annotated(arg: ast.arg) -> bool:
    if arg.annotation is None:
        return False
    return bool(_TENSOR_ANNOTATIONS.search(ast.unparse(arg.annotation)))


def _is_cpu_target(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")`` as a ``.to()`` argument."""
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return (isinstance(node, ast.Call) and (_dotted(node.func) or "")
            .endswith("device") and bool(node.args)
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "cpu")


class _ScopeIndex(ast.NodeVisitor):
    """First pass: find the query-path root functions of a module."""

    def __init__(self, tree: ast.Module):
        self.roots: set[ast.AST] = set()
        self._defs: list[dict[str, ast.AST]] = [{}]
        self._fns: list[ast.AST] = []  # enclosing functions, innermost last
        # module helpers that hand their parameter k to FusedRule(fn=...)
        self._rule_wrappers: dict[str, int] = {}
        for n in ast.walk(tree):
            if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            params = [a.arg for a in n.args.posonlyargs + n.args.args]
            for c in ast.walk(n):
                fn = self._fused_fn(c)
                if isinstance(fn, ast.Name) and fn.id in params:
                    self._rule_wrappers[n.name] = params.index(fn.id)

    @staticmethod
    def _fused_fn(node: ast.AST) -> ast.AST | None:
        """The ``fn`` argument of a ``FusedRule(...)`` call, else None."""
        if not (isinstance(node, ast.Call)
                and (_dotted(node.func) or "").rsplit(".", 1)[-1]
                == "FusedRule"):
            return None
        for kw in node.keywords:
            if kw.arg == "fn":
                return kw.value
        return node.args[0] if node.args else None

    def _mark(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            self.roots.add(node)
        elif isinstance(node, ast.Name):
            for scope in reversed(self._defs):
                if node.id in scope:
                    self.roots.add(scope[node.id])
                    return

    def visit_Call(self, node: ast.Call):
        if _dotted(node.func) in _LOWERING_CALLS and self._fns:
            self.roots.add(self._fns[-1])
        fn = self._fused_fn(node)
        if fn is not None:
            self._mark(fn)
        if (isinstance(node.func, ast.Name)
                and node.func.id in self._rule_wrappers):
            k = self._rule_wrappers[node.func.id]
            if k < len(node.args):
                self._mark(node.args[k])
        self.generic_visit(node)

    def _visit_def(self, node):
        self._defs[-1][node.name] = node
        args = node.args.posonlyargs + node.args.args
        if args and args[0].arg in {"ctx", "ctxs"}:
            self.roots.add(node)  # lowering-rule convention
        self._defs.append({})
        self._fns.append(node)
        self.generic_visit(node)
        self._fns.pop()
        self._defs.pop()

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def

    def visit_Lambda(self, node: ast.Lambda):
        self._fns.append(node)
        self.generic_visit(node)
        self._fns.pop()


class _SyncLint(ast.NodeVisitor):
    """Second pass: within one root, track tensor-derived names and flag
    host syncs and branches on tensors."""

    def __init__(self, path: str, root_name: str,
                 waivers: dict[int, set[tuple[int, str]]],
                 used_waivers: set[tuple[int, str]]):
        self.path = path
        self.root_name = root_name
        self.waivers = waivers
        self.used_waivers = used_waivers
        self.derived: set[str] = set()
        self.findings: list[Finding] = []
        self._tested: set[int] = set()  # BoolOps already flagged as a test

    # -- tensor-derivation dataflow -----------------------------------------
    def _is_tensor_expr(self, node: ast.AST) -> bool:
        if _is_static_expr(node):
            return False
        if isinstance(node, ast.Name):
            return node.id in self.derived
        if isinstance(node, ast.Call):
            name = _dotted(node.func) or ""
            if name.split(".", 1)[0] in _TENSOR_MODULES:
                return True
            if (isinstance(node.func, ast.Attribute)
                    and self._is_tensor_expr(node.func.value)):
                return True  # a method of a tensor
            return any(self._is_tensor_expr(a) for a in node.args)
        if isinstance(node, ast.BinOp):
            return (self._is_tensor_expr(node.left)
                    or self._is_tensor_expr(node.right))
        if isinstance(node, ast.UnaryOp):
            return self._is_tensor_expr(node.operand)
        if isinstance(node, ast.Compare):
            # identity tests (`is None`) are static dispatch, not data
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return (self._is_tensor_expr(node.left)
                    or any(self._is_tensor_expr(c) for c in node.comparators))
        if isinstance(node, ast.BoolOp):
            return any(self._is_tensor_expr(v) for v in node.values)
        if isinstance(node, (ast.Subscript, ast.Attribute)):
            return self._is_tensor_expr(node.value)
        if isinstance(node, ast.IfExp):
            return (self._is_tensor_expr(node.body)
                    or self._is_tensor_expr(node.orelse))
        return False

    def visit_Assign(self, node: ast.Assign):
        self.generic_visit(node)
        if self._is_tensor_expr(node.value):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        self.derived.add(n.id)

    def visit_AugAssign(self, node: ast.AugAssign):
        self.generic_visit(node)
        if (self._is_tensor_expr(node.value)
                and isinstance(node.target, ast.Name)):
            self.derived.add(node.target.id)

    # -- findings -----------------------------------------------------------
    def _flag(self, node: ast.AST, invariant: str, message: str,
              suggestion: str) -> None:
        line = getattr(node, "lineno", 0)
        hits = {w for w in self.waivers.get(line, ()) if w[1] == invariant}
        if hits:
            self.used_waivers.update(hits)
            return
        self.findings.append(Finding(
            _ANALYZER, invariant, message, subject=self.root_name,
            file=self.path, line=line, suggestion=suggestion))

    def visit_Call(self, node: ast.Call):
        name = _dotted(node.func) or ""
        # a method's name also where its receiver is no plain name chain
        # (``out["mean"].item()``)
        leaf = (node.func.attr if isinstance(node.func, ast.Attribute)
                else name.rsplit(".", 1)[-1])
        if isinstance(node.func, ast.Attribute) and leaf in _SYNC_METHODS:
            self._flag(node, "host-sync",
                       f".{leaf}() copies device data to the host and waits "
                       "for the stream",
                       "keep the value on the device, or lift the read out "
                       "of the query path (# audit: waive(host-sync) if "
                       "deliberate)")
        elif (isinstance(node.func, ast.Attribute) and leaf == "to"
              and any(_is_cpu_target(a) for a in
                      list(node.args) + [kw.value for kw in node.keywords
                                         if kw.arg == "device"])):
            self._flag(node, "host-sync",
                       '.to("cpu") copies device data to the host and waits '
                       "for the stream",
                       "keep the value on the device (# audit: "
                       "waive(host-sync) if deliberate)")
        elif (isinstance(node.func, ast.Name)
              and node.func.id in _CAST_CALLS and node.args
              and not all(_is_static_expr(a) for a in node.args)):
            self._flag(node, "host-sync",
                       f"{node.func.id}() of a possibly tensor-valued "
                       "argument reads it back to the host",
                       "cast with .to() on the device; shapes, numel(), "
                       "len() and dtypes are exempt (# audit: "
                       "waive(host-sync) if deliberate)")
        elif (name.split(".", 1)[0] in _NUMPY_NAMES
              and leaf in {"asarray", "array"} and node.args
              and not all(_is_static_expr(a) for a in node.args)):
            self._flag(node, "host-sync",
                       f"{name}() pulls a possibly tensor-valued argument "
                       "to host numpy",
                       "use torch on the device inside the query path "
                       "(# audit: waive(host-sync) if deliberate)")
        elif (isinstance(node.func, ast.Name)
              and node.func.id in {"str", "format", "repr"} and node.args
              and any(self._is_tensor_expr(a) for a in node.args)):
            self._flag(node, "host-sync",
                       f"{node.func.id}() stringifies a tensor-derived "
                       "value — it reads the tensor back like .item()",
                       "print shapes / dtypes (static) instead, or lift the "
                       "formatting out of the query path "
                       "(# audit: waive(host-sync) if deliberate)")
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr == "format"
              and any(self._is_tensor_expr(a) for a in
                      list(node.args) + [kw.value for kw in node.keywords])):
            self._flag(node, "host-sync",
                       "str.format() interpolates a tensor-derived value — "
                       "stringification is a host sync",
                       "format only static structure on the query path "
                       "(# audit: waive(host-sync) if deliberate)")
        self.generic_visit(node)

    def visit_JoinedStr(self, node: ast.JoinedStr):
        for part in node.values:
            if (isinstance(part, ast.FormattedValue)
                    and self._is_tensor_expr(part.value)):
                self._flag(node, "host-sync",
                           "f-string interpolates a tensor-derived value — "
                           "stringification is a host sync (static "
                           "interpolations like f'{x.shape}' are exempt)",
                           "interpolate shapes / dtypes, or move the message "
                           "off the query path "
                           "(# audit: waive(host-sync) if deliberate)")
                break
        self.generic_visit(node)

    def _check_branch(self, node: ast.AST, test: ast.AST, kind: str):
        self._tested.add(id(test))
        if self._is_tensor_expr(test):
            self._flag(node, "tracer-branch",
                       f"{kind} on a tensor-derived value calls "
                       "Tensor.__bool__, a host sync",
                       "use torch.where / masked arithmetic; branch only on "
                       "static structure "
                       "(# audit: waive(tracer-branch) if deliberate)")

    def visit_If(self, node: ast.If):
        self._check_branch(node, node.test, "`if` branch")
        self.generic_visit(node)

    def visit_While(self, node: ast.While):
        self._check_branch(node, node.test, "`while` loop")
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp):
        self._check_branch(node, node.test, "conditional expression")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert):
        self._check_branch(node, node.test, "`assert`")
        self.generic_visit(node)

    def visit_BoolOp(self, node: ast.BoolOp):
        # every operand but the last is tested for truth (a BoolOp that is
        # itself the test of an if / while / assert is flagged there)
        if id(node) not in self._tested:
            op = type(node.op).__name__.lower()
            for value in node.values[:-1]:
                if self._is_tensor_expr(value):
                    self._check_branch(node, value, f"`{op}` operand")
                    break
        self.generic_visit(node)


def _lint_root(path: str, root: ast.AST,
               waivers: dict[int, set[tuple[int, str]]],
               used_waivers: set[tuple[int, str]]) -> list[Finding]:
    name = getattr(root, "name", "<lambda>")
    lint = _SyncLint(path, name, waivers, used_waivers)
    args = root.args
    # ctx/ctxs are mixed containers (static structure + device data):
    # branching on their structure is legal, so only tensor-annotated
    # params seed the derived set; device data inside ctx surfaces through
    # torch.* calls and tensor methods in the dataflow.
    for arg in args.posonlyargs + args.args + args.kwonlyargs:
        if _tensor_annotated(arg):
            lint.derived.add(arg.arg)
    body = root.body if isinstance(root.body, list) else [root.body]
    for stmt in body:
        lint.visit(stmt)
    return lint.findings


def lint_source(source: str, path: str = "<string>") -> list[Finding]:
    """Lint one module's source text; returns findings (used directly by
    the fixture tests)."""
    tree = ast.parse(source)
    index = _ScopeIndex(tree)
    index.visit(tree)
    waivers = _waivers(source)
    used: set[tuple[int, str]] = set()
    findings: list[Finding] = []
    seen: set[tuple] = set()
    for root in sorted(index.roots, key=lambda r: r.lineno):
        for f in _lint_root(path, root, waivers, used):
            key = (f.file, f.line, f.invariant, f.message)
            if key not in seen:
                seen.add(key)
                findings.append(f)
    declared = sorted({w for ws in waivers.values() for w in ws
                       if w[1] in _OWNED_WAIVERS})
    for cline, name in declared:
        if (cline, name) not in used:
            findings.append(Finding(
                _ANALYZER, "stale-waiver",
                f"# audit: waive({name}) suppresses no {name} finding — "
                "the waived code has moved or been fixed",
                subject=name, file=path, line=cline, severity="warning",
                suggestion="delete the stale waiver comment"))
    return findings


def analyze_trace_safety(src_root: str | Path | None = None,
                         packages: tuple = _DEFAULT_ROOTS) -> list[Finding]:
    """Lint every module under ``src/repro_torch/{core,analytics,...}``."""
    if src_root is None:
        src_root = Path(__file__).resolve().parent.parent
    src_root = Path(src_root)
    findings: list[Finding] = []
    for pkg in packages:
        for py in sorted((src_root / pkg).rglob("*.py")):
            rel = str(py.relative_to(src_root.parent.parent))
            findings.extend(lint_source(py.read_text(), rel))
    return findings
