"""Analyzer (4): program-cache key soundness.

The engine (``repro_torch.analytics.engine``) and the shard layer
(``repro_torch.shard.exec``) keep programs in LRU caches of Python
callables: ``self._call(key, build, *args)`` / ``self._programs`` and
``self._program(key, build)`` / ``self._jitted``.  On a miss ``build()``
makes the program — a closure over the statics of the query that missed —
and every later call with an equal key runs that closure.  A free variable
of ``build`` (or of the closure it returns) that the key does not
distinguish therefore makes two different queries share one program and
return the first query's answer to the second.  Under JAX the same mistake
only reused a stale compile; here it returns a wrong result.

For every cache site this pass:

1. extracts the **free variables** of ``build`` and of everything nested in
   it — lexical captures via :mod:`symtable` (CPython's own closure
   analysis; since Python 3.12 comprehensions are inlined into their
   function, PEP 709, so a capture used only inside a comprehension is a
   free variable of the enclosing closure) plus the free names of
   default-argument expressions;
2. takes the **key expression** — the first argument of the call;
3. verifies each free variable is **covered**: it is a component of the
   key (a name, or the very projection ``x.attr`` the key holds), is fully
   derived from key components (forward closure), is a module global /
   import / builtin / local helper function (recursed), is ``self`` (the
   cache's owner), or is declared invariant with
   ``# audit: invariant(name)`` on the call or the ``def build`` line.
   Unlike the reference, a name that merely flows *into* a key component
   is not covered: ``plan`` is computed from ``region``, but a key holding
   ``plan.fused`` does not tell two regions apart.

Two further checks ride on the same machinery:

* **kernel-mode keys** (``unkeyed-kernel-mode``) — a program that reaches
  the kernel-backed lowering layer (``oplib.compute``,
  ``oplib.StageContext``, ``oplib.summarize_slab``, ``decode_device``, or
  ``expr.lower``, which lowers through ``compute``) selects fused or torch
  rules when it runs, so its key must include ``oplib.kernel_sig()`` —
  directly, or in a key builder such as ``batch_key``.
* **dispatch coverage** (``uncovered-dispatch-input``) — every ``ctx``
  attribute a ``FusedRule.covers`` predicate reads must be an input the
  engine's program key distinguishes (layout, region plan, seed); a
  predicate branching on an unkeyed attribute would route two
  key-identical calls to different lowerings.

A ``# audit: invariant(...)`` declaration that suppresses nothing is
reported at *warning* severity (``stale-waiver``).
"""
from __future__ import annotations

import ast
import builtins
import re
import symtable
from pathlib import Path

from .findings import Finding

_ANALYZER = "jitkey"

#: the program-cache methods: ``<cache>(key, build, ...)``.
_CACHE_METHODS = frozenset({"_call", "_program"})
_MUTATORS = frozenset({"append", "extend", "add", "update", "insert"})
_INVARIANT_RE = re.compile(r"#\s*audit:\s*invariant\(([A-Za-z0-9_,\s]+)\)")
_BUILTINS = frozenset(dir(builtins))

#: every module of the port that keeps an ``OrderedDict`` of programs
#: (pinned by ``tests/test_torch_audit.py`` against a scan of the package).
_DEFAULT_TARGETS = ("analytics/engine.py", "shard/exec.py")

# Exact dotted callees that enter the kernel-switched lowering layer.  A
# program calling any of these selects fused or torch rules when it runs,
# so its cache key must fold in ``oplib.kernel_sig()``.  Deliberately exact
# names: ``oplib.TemporalSummary`` (a plain container) must not drag the
# mode into keys that don't dispatch.
_DISPATCH_DOTTED = frozenset({
    "oplib.compute", "oplib.StageContext", "oplib.select_rule",
    "oplib.summarize_slab", "encode.decode_device",
    "encode_mod.decode_device", "expr_mod.lower", "expr.lower",
})

# ctx attributes a FusedRule.covers predicate may branch on: each maps to a
# component of the engine's batch_key (layout_key(field) covers scheme +
# field geometry; plan -> region; _seed -> seed_sig; stage is explicit).
_COVERS_KEYED_ATTRS = frozenset({"scheme", "field", "plan", "_seed",
                                 "stage"})

_DEFAULT_FUSED_TARGETS = ("core/fused.py",)


# ---------------------------------------------------------------------------
# small ast utilities
# ---------------------------------------------------------------------------

def _dotted(node: ast.AST) -> str | None:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _free_names(node: ast.AST) -> set[str]:
    """Names an expression reads, minus names it binds itself
    (comprehension targets, lambda params, walrus targets)."""
    loads: set[str] = set()
    bound: set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            (loads if isinstance(n.ctx, ast.Load) else bound).add(n.id)
        elif isinstance(n, ast.comprehension):
            for t in ast.walk(n.target):
                if isinstance(t, ast.Name):
                    bound.add(t.id)
        elif isinstance(n, ast.Lambda):
            a = n.args
            for arg in a.posonlyargs + a.args + a.kwonlyargs:
                bound.add(arg.arg)
    return loads - bound


def _bound_targets(t: ast.AST):
    """Names an assignment target *binds* — Subscript/Attribute targets
    mutate containers, they do not bind the names inside them."""
    if isinstance(t, ast.Name):
        yield t.id
    elif isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            yield from _bound_targets(e)
    elif isinstance(t, ast.Starred):
        yield from _bound_targets(t.value)


def _param_names(node: ast.AST) -> list[str]:
    a = node.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def _default_frees(node: ast.AST) -> set[str]:
    """Free names of default-arg expressions — evaluated in the *enclosing*
    scope at definition time (the ``_ops=ops`` static-binding idiom)."""
    a = node.args
    out: set[str] = set()
    for d in list(a.defaults) + [d for d in a.kw_defaults if d is not None]:
        out |= _free_names(d)
    return out


# ---------------------------------------------------------------------------
# per-module index
# ---------------------------------------------------------------------------

class _Module:
    def __init__(self, source: str, path: str):
        self.path = path
        self.source = source
        self.tree = ast.parse(source)
        self.lines = source.splitlines()
        # symtable: (name, lineno) -> function block (CPython closure info)
        self.blocks: dict[tuple, symtable.SymbolTable] = {}

        def walk(tb):
            for child in tb.get_children():
                if child.get_type() == "function":
                    self.blocks[(child.get_name(), child.get_lineno())] = child
                walk(child)

        walk(symtable.symtable(source, path, "exec"))
        # names bound at module level, plus every import anywhere (imports
        # bind invariant module objects regardless of scope)
        self.module_bound: set[str] = set()
        for stmt in self.tree.body:
            self.module_bound |= _stmt_bindings(stmt)
        self.import_bound: set[str] = set()
        for n in ast.walk(self.tree):
            if isinstance(n, (ast.Import, ast.ImportFrom)):
                for alias in n.names:
                    self.import_bound.add(
                        (alias.asname or alias.name).split(".", 1)[0])
        # every ``# audit: invariant(a, b)`` declaration as (line, name) —
        # the identity stale-waiver accounting is keyed on
        self.invariant_decls: list[tuple[int, str]] = []
        for i, line in enumerate(self.lines, start=1):
            m = _INVARIANT_RE.search(line)
            if m:
                for w in m.group(1).split(","):
                    w = w.strip()
                    if w:
                        self.invariant_decls.append((i, w))

    def exempt(self, name: str) -> bool:
        return (name in _BUILTINS or name in self.module_bound
                or name in self.import_bound)

    def waived_decls(self, lineno: int) -> set[tuple[int, str]]:
        """Declarations governing a site: same line or the line above."""
        return {(ln, n) for (ln, n) in self.invariant_decls
                if ln in (lineno, lineno - 1)}

    def waived(self, lineno: int) -> set[str]:
        return {n for _, n in self.waived_decls(lineno)}

    def frees_of(self, fnode: ast.AST) -> set[str]:
        """Closure frees (symtable) + default-expr frees of one def/lambda."""
        name = getattr(fnode, "name", "lambda")
        block = self.blocks.get((name, fnode.lineno))
        frees = set(block.get_frees()) if block is not None else set()
        return frees | _default_frees(fnode)


def _stmt_bindings(stmt: ast.stmt) -> set[str]:
    out: set[str] = set()
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        out.add(stmt.name)
    elif isinstance(stmt, (ast.Import, ast.ImportFrom)):
        for alias in stmt.names:
            out.add((alias.asname or alias.name).split(".", 1)[0])
    elif isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        for t in targets:
            out.update(_bound_targets(t))
    elif isinstance(stmt, (ast.If, ast.Try, ast.For, ast.While, ast.With)):
        for sub in ast.iter_child_nodes(stmt):
            if isinstance(sub, ast.stmt):
                out |= _stmt_bindings(sub)
    return out


# ---------------------------------------------------------------------------
# dataflow inside one function
# ---------------------------------------------------------------------------

class _Flow:
    """Assignment dataflow of one function body: ``edges[target] = frees``
    per binding (append/extend mutations included), supporting the backward
    slice (what flows *into* an expression)."""

    def __init__(self, fnode: ast.AST, mod: _Module):
        self.mod = mod
        self.edges: list[tuple[str, set[str]]] = []
        self.local_defs: dict[str, ast.AST] = {}
        for stmt in ast.walk(fnode):
            if stmt is fnode:
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.local_defs[stmt.name] = stmt
            elif isinstance(stmt, ast.Assign):
                frees = _free_names(stmt.value)
                for t in stmt.targets:
                    for name in _bound_targets(t):
                        self.edges.append((name, frees))
            elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
                if stmt.value is not None and isinstance(stmt.target, ast.Name):
                    self.edges.append((stmt.target.id,
                                       _free_names(stmt.value)))
            elif isinstance(stmt, ast.For):
                frees = _free_names(stmt.iter)
                for name in _bound_targets(stmt.target):
                    self.edges.append((name, frees))
            elif isinstance(stmt, ast.NamedExpr):
                if isinstance(stmt.target, ast.Name):
                    self.edges.append((stmt.target.id,
                                       _free_names(stmt.value)))
            elif (isinstance(stmt, ast.Call)
                  and isinstance(stmt.func, ast.Attribute)
                  and stmt.func.attr in _MUTATORS
                  and isinstance(stmt.func.value, ast.Name)):
                frees: set[str] = set()
                for a in stmt.args:
                    frees |= _free_names(a)
                self.edges.append((stmt.func.value.id, frees))

    def _expand(self, names: set[str]) -> set[str]:
        """Substitute local helper functions by their own free variables."""
        out: set[str] = set()
        seen: set[str] = set()
        work = list(names)
        while work:
            n = work.pop()
            if n in seen:
                continue
            seen.add(n)
            if n in self.local_defs:
                work.extend(self.mod.frees_of(self.local_defs[n]))
            else:
                out.add(n)
        return out

    def backward(self, roots: set[str]) -> set[str]:
        covered = set(roots)
        changed = True
        while changed:
            changed = False
            for target, frees in self.edges:
                if target in covered:
                    new = self._expand(frees) - covered
                    if new:
                        covered |= new
                        changed = True
        return covered


# ---------------------------------------------------------------------------
# program-cache sites
# ---------------------------------------------------------------------------

def _paths(node: ast.AST) -> set[str]:
    """Access paths an expression reads: a name, or ``name.attr...`` where
    an attribute chain is read without being called (a key component
    ``plan.fused`` keys that projection, not all of ``plan``)."""
    bound = set()
    parents: dict[int, ast.AST] = {}
    for n in ast.walk(node):
        for child in ast.iter_child_nodes(n):
            parents[id(child)] = n
        if isinstance(n, ast.comprehension):
            bound |= {t.id for t in ast.walk(n.target)
                      if isinstance(t, ast.Name)}
        elif isinstance(n, ast.Lambda):
            a = n.args
            bound |= {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
    out = set()
    for n in ast.walk(node):
        if not (isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
                and n.id not in bound):
            continue
        top = n
        while (isinstance(parents.get(id(top)), ast.Attribute)
               and parents[id(top)].value is top):
            top = parents[id(top)]
        called = (isinstance(parents.get(id(top)), ast.Call)
                  and parents[id(top)].func is top)
        out.add(n.id if top is n or called else _dotted(top) or n.id)
    return out


def _key_covered(kx: ast.AST, fnode: ast.AST, flow: _Flow,
                 mod: _Module) -> set[str]:
    """Names the key covers: the key's components (through the assignment
    of a key variable, and the free names of local helpers it calls), and
    every name assigned only from covered names, covered projections or
    module-level names.  A component's own inputs are *not* covered: a key
    holding ``plan.fused`` does not distinguish every plan."""
    comps = _paths(kx)
    if isinstance(kx, ast.Name):
        rhs = [st.value for st in ast.walk(fnode)
               if isinstance(st, ast.Assign)
               and kx.id in {n for t in st.targets for n in _bound_targets(t)}]
        if rhs:
            comps = set().union(*(_paths(v) for v in rhs))
    names = {c for c in comps if "." not in c}
    projections = comps - names
    names = flow._expand(names)
    edges = []
    for st in ast.walk(fnode):
        if isinstance(st, ast.Assign):
            for t in st.targets:
                for name in _bound_targets(t):
                    edges.append((name, _paths(st.value)))
        elif isinstance(st, ast.For):
            for name in _bound_targets(st.target):
                edges.append((name, _paths(st.iter)))
    changed = True
    while changed:
        changed = False
        for target, reads in edges:
            if target in names:
                continue
            if all(r in projections or r.split(".")[0] in names
                   or mod.exempt(r.split(".")[0])
                   or r.split(".")[0] in flow.local_defs for r in reads):
                names.add(target)
                changed = True
    return names


def _is_cache_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call) and len(node.args) >= 2
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _CACHE_METHODS)


def _key_nodes(kx: ast.AST, fnode: ast.AST, flow: _Flow,
               defs_by_name: dict[str, list[ast.AST]]) -> list[ast.AST]:
    """What the key's value is built from: the key expression itself, the
    RHS of every assignment on its backward slice, and the module functions
    reachable from that slice (key builders like ``batch_key``)."""
    names = flow.backward(flow._expand(_free_names(kx)))
    nodes = [kx]
    for stmt in ast.walk(fnode):
        if isinstance(stmt, ast.Assign):
            bound = {n for t in stmt.targets for n in _bound_targets(t)}
            if bound & names:
                nodes.append(stmt.value)
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            if (stmt.value is not None and isinstance(stmt.target, ast.Name)
                    and stmt.target.id in names):
                nodes.append(stmt.value)
    nodes += [d for n in sorted(names & set(defs_by_name))
              for d in defs_by_name[n]]
    return nodes


def _keys_kernel_mode(nodes: list[ast.AST]) -> bool:
    """Does any of ``nodes`` call ``kernel_sig()`` (a docstring naming it
    does not count)?"""
    return any(isinstance(n, ast.Call)
               and (_dotted(n.func) or "").rsplit(".", 1)[-1] == "kernel_sig"
               for node in nodes for n in ast.walk(node))


def _dispatches_kernels(fnode: ast.AST,
                        local_defs: dict[str, ast.AST]) -> bool:
    """Does the program (or a local helper it calls) reach the
    kernel-backed lowering layer?"""
    seen: set[str] = set()
    work = [fnode]
    while work:
        f = work.pop()
        for n in ast.walk(f):
            if not isinstance(n, ast.Call):
                continue
            if (_dotted(n.func) or "") in _DISPATCH_DOTTED:
                return True
            if (isinstance(n.func, ast.Name) and n.func.id in local_defs
                    and n.func.id not in seen):
                seen.add(n.func.id)
                work.append(local_defs[n.func.id])
    return False


def _analyze_module(mod: _Module) -> list[Finding]:
    findings: list[Finding] = []
    used_decls: set[tuple[int, str]] = set()
    parents: dict[ast.AST, ast.AST | None] = {}

    def assign_parents(node, fn):
        parents[node] = fn
        for child in ast.iter_child_nodes(node):
            assign_parents(
                child,
                node if isinstance(node, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)) else fn)

    assign_parents(mod.tree, None)
    defs_by_name: dict[str, list[ast.AST]] = {}
    for n in ast.walk(mod.tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs_by_name.setdefault(n.name, []).append(n)

    for node in ast.walk(mod.tree):
        if not _is_cache_call(node):
            continue
        kx, target = node.args[0], node.args[1]
        enclosing = parents.get(node)
        if isinstance(target, ast.Name):
            cands = [d for d in defs_by_name.get(target.id, [])
                     if parents.get(d) is enclosing]
            if not cands:
                if not mod.exempt(target.id):
                    findings.append(Finding(
                        _ANALYZER, "unkeyed-closure",
                        f"program cache builds from {target.id}, which this "
                        "pass cannot resolve to a local def; its closure "
                        "cannot be verified against the key",
                        subject=target.id, file=mod.path, line=node.lineno,
                        suggestion="pass a local def or lambda as build"))
                continue
            built = cands[-1]
        elif isinstance(target, ast.Lambda):
            built = target
        else:
            continue
        if enclosing is None:
            continue
        name = getattr(built, "name", "<lambda>")
        wdecls = mod.waived_decls(node.lineno) | mod.waived_decls(
            built.lineno)
        waived = {n for _, n in wdecls}

        flow = _Flow(enclosing, mod)
        covered = _key_covered(kx, enclosing, flow, mod)
        # the cache is an attribute of ``self``: every program of it closes
        # over the same ``self``
        unkeyed = {f for f in flow._expand(mod.frees_of(built))
                   if f not in covered and not mod.exempt(f) and f != "self"}
        used_decls.update(d for d in wdecls if d[1] in unkeyed)
        for var in sorted(unkeyed - waived):
            findings.append(Finding(
                _ANALYZER, "unkeyed-closure",
                f"program {name!r} closes over {var!r}, which the cache key "
                f"of {enclosing.name!r} does not cover — two calls differing "
                f"only in {var!r} would run one program and get the first "
                "call's answer",
                subject=var, file=mod.path, line=node.lineno,
                suggestion=f"include {var!r} (or a signature of it) in the "
                           "cache key, or declare it with "
                           f"# audit: invariant({var})"))

        if _dispatches_kernels(built, flow.local_defs):
            if "kernel_sig" in waived:
                used_decls.update(d for d in wdecls if d[1] == "kernel_sig")
            elif not _keys_kernel_mode(
                    _key_nodes(kx, enclosing, flow, defs_by_name)):
                findings.append(Finding(
                    _ANALYZER, "unkeyed-kernel-mode",
                    f"program {name!r} dispatches through the kernel "
                    f"lowering layer but the cache key of {enclosing.name!r} "
                    "never folds in oplib.kernel_sig() — a call under "
                    "override_mode('off') would reuse a program built with "
                    "the fused rules on, or the other way round",
                    subject=enclosing.name, file=mod.path, line=node.lineno,
                    suggestion="include oplib.kernel_sig() in the cache key "
                               "(directly, or in the key builder)"))

    for line, name in sorted(set(mod.invariant_decls)):
        if (line, name) not in used_decls:
            findings.append(Finding(
                _ANALYZER, "stale-waiver",
                f"# audit: invariant({name}) declaration suppresses "
                "nothing in this run — the free variable it names is "
                "covered, renamed, or gone",
                subject=name, file=mod.path, line=line,
                suggestion="delete the stale declaration (or re-attach it "
                           "to the cache site it was meant for)",
                severity="warning"))
    return findings


def program_caches(src_root: str | Path | None = None
                   ) -> list[tuple[str, str]]:
    """Every ``OrderedDict`` of callables in the package, as ``(module
    path relative to the package, name)``: an ``OrderedDict`` whose
    annotation names ``Callable`` or whose entries are stored from a call of
    ``build``.  ``analyze_jit_keys``'s targets must hold all of them."""
    if src_root is None:
        src_root = Path(__file__).resolve().parent.parent
    src_root = Path(src_root)
    out = []
    for py in sorted(src_root.rglob("*.py")):
        tree = ast.parse(py.read_text())
        dicts: dict[str, bool] = {}
        for n in ast.walk(tree):
            if isinstance(n, (ast.Assign, ast.AnnAssign)) and isinstance(
                    n.value, ast.Call) and (_dotted(n.value.func) or "") \
                    .endswith("OrderedDict"):
                targets = n.targets if isinstance(n, ast.Assign) else [n.target]
                ann = ast.unparse(n.annotation) if isinstance(
                    n, ast.AnnAssign) else ""
                for t in targets:
                    key = ast.unparse(t)
                    dicts[key] = dicts.get(key, False) or "Callable" in ann
        if not dicts:
            continue
        built: set[str] = set()  # names bound to build()
        for n in ast.walk(tree):
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call) \
                    and (_dotted(n.value.func) or "") == "build":
                for t in n.targets:
                    built.add(ast.unparse(t))
        for n in ast.walk(tree):
            if not isinstance(n, ast.Assign):
                continue
            value = n.value
            from_build = ((isinstance(value, ast.Call)
                           and (_dotted(value.func) or "") == "build")
                          or ast.unparse(value) in built)
            for t in n.targets:
                if (isinstance(t, ast.Subscript) and from_build
                        and ast.unparse(t.value) in dicts):
                    dicts[ast.unparse(t.value)] = True
        rel = str(py.relative_to(src_root))
        out += [(rel, k) for k, is_prog in sorted(dicts.items()) if is_prog]
    return out


# ---------------------------------------------------------------------------
# FusedRule.covers predicates
# ---------------------------------------------------------------------------

def analyze_covers_source(
        source: str, path: str = "core/fused.py", *,
        covered_attrs: frozenset = _COVERS_KEYED_ATTRS) -> list[Finding]:
    """Verify every ``FusedRule`` covers predicate only branches on ctx
    attributes the engine's program key distinguishes.

    Rule selection runs inside the cached program; a predicate reading an
    attribute outside ``covered_attrs`` routes two key-identical calls to
    different lowerings.  The walk follows the predicate's ctx parameter through
    module helpers it forwards ctx to.
    """
    findings: list[Finding] = []
    mod = _Module(source, path)
    defs_by_name: dict[str, list[ast.AST]] = {}
    for n in ast.walk(mod.tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs_by_name.setdefault(n.name, []).append(n)

    for n in ast.walk(mod.tree):
        if not (isinstance(n, ast.Call)
                and (_dotted(n.func) or "").rsplit(".", 1)[-1]
                == "FusedRule"):
            continue
        cov: ast.AST | None = n.args[1] if len(n.args) >= 2 else None
        for kw in n.keywords:
            if kw.arg == "covers":
                cov = kw.value
        if cov is None:
            continue
        if isinstance(cov, ast.Lambda):
            fnode: ast.AST | None = cov
        elif isinstance(cov, ast.Name):
            cands = defs_by_name.get(cov.id, [])
            fnode = cands[-1] if cands else None
        else:
            fnode = None
        if fnode is None:
            findings.append(Finding(
                _ANALYZER, "uncovered-dispatch-input",
                "FusedRule covers predicate "
                f"{ast.unparse(cov)!r} cannot be resolved to a function in "
                "this module, so its dispatch inputs cannot be verified "
                "against the program key",
                subject=ast.unparse(cov), file=path, line=n.lineno,
                suggestion="use a module-level def or inline lambda as the "
                           "covers predicate"))
            continue

        waived = mod.waived(n.lineno) | mod.waived(fnode.lineno)
        # transitively collect first-level ctx-attribute reads
        reads: dict[str, int] = {}
        seen: set[int] = set()
        params = _param_names(fnode)
        work: list[tuple[ast.AST, str]] = (
            [(fnode, params[0])] if params else [])
        while work:
            f, ctxp = work.pop()
            if id(f) in seen:
                continue
            seen.add(id(f))
            for sub in ast.walk(f):
                if (isinstance(sub, ast.Attribute)
                        and isinstance(sub.value, ast.Name)
                        and sub.value.id == ctxp):
                    reads.setdefault(sub.attr, sub.lineno)
                elif (isinstance(sub, ast.Call)
                      and isinstance(sub.func, ast.Name)
                      and sub.func.id in defs_by_name):
                    callee = defs_by_name[sub.func.id][-1]
                    cps = _param_names(callee)
                    for i, a in enumerate(sub.args):
                        if (isinstance(a, ast.Name) and a.id == ctxp
                                and i < len(cps)):
                            work.append((callee, cps[i]))
        for attr in sorted(reads):
            if attr in covered_attrs or attr in waived:
                continue
            findings.append(Finding(
                _ANALYZER, "uncovered-dispatch-input",
                "FusedRule covers predicate "
                f"{getattr(fnode, 'name', '<lambda>')!r} branches on "
                f"ctx.{attr}, which the engine's program key does not "
                "distinguish — two key-identical calls could select "
                "different lowerings",
                subject=attr, file=path, line=reads[attr],
                suggestion=f"fold ctx.{attr} (or a signature of it) into "
                           "batch_key, or restrict the predicate to "
                           f"{sorted(covered_attrs)}"))
    return findings


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def analyze_source(source: str, path: str = "<string>") -> list[Finding]:
    """Analyze one module's source text (used by the fixture tests)."""
    return _analyze_module(_Module(source, path))


def analyze_jit_keys(src_root: str | Path | None = None,
                     targets: tuple = _DEFAULT_TARGETS,
                     fused_targets: tuple = _DEFAULT_FUSED_TARGETS,
                     ) -> list[Finding]:
    """Analyze the program-cache modules (engine and shard programs) for
    under-keyed closures and unkeyed kernel mode, and the covers
    predicates for branches on unkeyed inputs."""
    if src_root is None:
        src_root = Path(__file__).resolve().parent.parent
    src_root = Path(src_root)
    findings: list[Finding] = []
    for rel in targets:
        py = src_root / rel
        if not py.exists():
            findings.append(Finding(
                _ANALYZER, "missing-target",
                f"expected program-cache module {rel} is absent",
                subject=rel))
            continue
        path = str(py.relative_to(src_root.parent.parent))
        findings.extend(analyze_source(py.read_text(), path))
    for rel in fused_targets:
        py = src_root / rel
        if not py.exists():
            findings.append(Finding(
                _ANALYZER, "missing-target",
                f"expected fused-rule module {rel} is absent",
                subject=rel))
            continue
        path = str(py.relative_to(src_root.parent.parent))
        findings.extend(analyze_covers_source(py.read_text(), path))
    return findings
