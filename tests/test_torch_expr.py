"""Expression DAGs of the port (``repro_torch.core.expr`` and
``query(exprs=...)``) against the JAX reference.

The same numpy fields are compressed by the reference and carried into the
port with ``convert.from_arrays``, so both packages see identical containers.
What is held, with its tolerance:

* inside the port, **bitwise**: every root equals composing the single-op
  results of ``oplib.compute`` at the same stage (one prelude per distinct
  leaf, one postlude per distinct application), seeded equals cold, and the
  closed-form oracles (rigid-rotation vorticity 2, quadratic ensemble delta
  4) hold to ``rtol=1e-5, atol=1e-3``;
* against the reference: program keys, slot structure, components and
  joint plans **exactly**; stencil roots (a single derivative or Laplacian)
  **bitwise**; combinations of stencils ``rtol=1e-6``,
  ``atol=1e-6·max|ref|`` (XLA's CPU fusion may contract a scaled difference
  into a multiply-add where torch rounds the products first, as for
  divergence / curl in ``tests/test_torch_slice.py``); anything holding a
  statistic ``rtol=1e-5, atol=1e-5`` (the flat f32 reductions run in
  another order);
* the same exception types for the same conditions.

The DAG property test binds its strategy by keyword (``spec=``) and runs
every drawn DAG through the port's ``compute_exprs``, the composed port
oracle and the reference's ``compute_exprs``.  Temporal expressions
(``tmean`` / ``tdelta`` / ... over streams, by object or by store id) equal
the flat temporal queries composed, bitwise, and the reference's within
``error_analysis.temporal_round_bound``; their dispatch counters are the
reference's.
"""
import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import analytics as janalytics
from repro.core import Stage as JStage
from repro.core import by_name as jax_by_name
from repro.core import expr as jexpr
from repro.core import oplib as joplib
from repro_torch import convert
from repro_torch.analytics import BatchedAnalytics, ExprPlan, plan_expr, query
from repro_torch.analytics.query import _query_opset
from repro_torch.core import Stage, UnsupportedStageError, expr, oplib
from repro_torch.core.stages import LEAVES
from repro_torch.store import FieldStore

ALL = ["hszp", "hszx", "hszp_nd", "hszx_nd"]
ND = ["hszp_nd", "hszx_nd"]
N0, N1 = 48, 64
REGION = (slice(8, 40), slice(16, 48))


def _grid_2d():
    i = np.arange(N0, dtype=np.float32)[:, None]
    j = np.arange(N1, dtype=np.float32)[None, :]
    return i, j


def to_port(jc):
    """The reference container ``jc`` as the port's, on the CPU."""
    kind = type(jc).__name__
    arrays = {n: np.asarray(getattr(jc, n)) for n in LEAVES[kind]}
    meta = {"scheme": jc.scheme.value, "shape": jc.shape,
            "padded_shape": jc.padded_shape, "block": jc.block,
            "orig_dtype": np.dtype(jc.orig_dtype).name}
    if kind == "Encoded":
        meta["bits"] = jc.bits
    return convert.from_arrays(kind, arrays, meta, device="cpu")


def _pair(scheme, data, **eb):
    """(reference field, port field) of one numpy array."""
    jc = jax_by_name(scheme).compress(jnp.asarray(data, jnp.float32), **eb)
    return jc, to_port(jc)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bitwise(want, got, what=""):
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got), what
    for w, g in zip(want, got):
        w, g = _np(w), _np(g)
        assert (w.shape, w.dtype) == (g.shape, g.dtype), what
        assert w.tobytes() == g.tobytes(), what


def _close(want, got, rtol, what="", atol_rel=None, atol=0.0):
    w, g = _np(want), _np(got)
    assert w.shape == g.shape, what
    if atol_rel is not None:
        atol = atol_rel * float(np.abs(w).max())
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)


def _stages(scheme):
    return [Stage.Q, Stage.F] + ([Stage.P] if scheme.endswith("_nd") else [])


def _op(c, name, stage, *, axis=0, region=None):
    return oplib.compute(c, name, stage, axis=axis, region=region)[name]


def _jexprs(e, stage, **kw):
    return joplib.compute_exprs(e, JStage(int(stage)), **kw)


# ===========================================================================
# closed-form oracles
# ===========================================================================

@pytest.mark.parametrize("scheme", ALL)
def test_vorticity_rigid_rotation_exact(scheme):
    """dv/dx - du/dy of (u, v) = (-y, x) is exactly 2; the port's expression
    equals its composed single-op results bitwise and the reference's
    expression to rtol 1e-6."""
    i, j = _grid_2d()
    (ju, tu) = _pair(scheme, -(j + np.zeros((N0, N1), np.float32)),
                     abs_eb=0.25)
    (jv, tv) = _pair(scheme, i + np.zeros((N0, N1), np.float32), abs_eb=0.25)
    vort = expr.sub(expr.derivative(tv, axis=0), expr.derivative(tu, axis=1))
    jvort = jexpr.sub(jexpr.derivative(jv, axis=0),
                      jexpr.derivative(ju, axis=1))
    for stage in _stages(scheme):
        got = oplib.compute_exprs(vort, stage)
        oracle = (_op(tv, "derivative", stage, axis=0)
                  - _op(tu, "derivative", stage, axis=1))
        _bitwise(oracle, got, (scheme, stage))
        np.testing.assert_allclose(
            got.numpy(), np.full((N0 - 2, N1 - 2), 2.0, np.float32),
            rtol=1e-5, atol=1e-3)
        _close(_jexprs(jvort, stage), got, 1e-6, (scheme, stage),
               atol_rel=1e-6)


@pytest.mark.parametrize("scheme", ALL)
def test_ensemble_delta_quadratics_exact(scheme):
    """laplacian(2(i²+j²)) - laplacian(i²+j²) is exactly 8 - 4 = 4."""
    i, j = _grid_2d()
    f = i * i + j * j
    j1, t1 = _pair(scheme, 2.0 * f, abs_eb=0.25)
    j2, t2 = _pair(scheme, f, abs_eb=0.25)
    delta = expr.laplacian(t1) - expr.laplacian(t2)
    jdelta = jexpr.laplacian(j1) - jexpr.laplacian(j2)
    for stage in _stages(scheme):
        got = oplib.compute_exprs(delta, stage)
        oracle = _op(t1, "laplacian", stage) - _op(t2, "laplacian", stage)
        _bitwise(oracle, got, (scheme, stage))
        np.testing.assert_allclose(
            got.numpy(), np.full((N0 - 2, N1 - 2), 4.0, np.float32),
            rtol=1e-5, atol=1e-3)
        _close(_jexprs(jdelta, stage), got, 1e-6, (scheme, stage),
               atol_rel=1e-6)


# ===========================================================================
# expression == op-compose, all schemes, ± region, ± store seeding
# ===========================================================================

@pytest.mark.parametrize("scheme", ALL)
@pytest.mark.parametrize("region", [None, REGION], ids=["full", "region"])
def test_expression_matches_compose(scheme, region, field_2d):
    """A mixed DAG (stencil + scaled statistics, shared leaf) equals the
    composed single-op results bitwise at every feasible stage, and the
    reference's expression to rtol 1e-5."""
    j1, t1 = _pair(scheme, field_2d[:N0, :N1], rel_eb=1e-3)
    j2, t2 = _pair(scheme, field_2d[50:50 + N0, 20:20 + N1], rel_eb=1e-3)
    e = (expr.laplacian(t1) + 0.5 * expr.mean(t2)) - expr.std(t1)
    je = (jexpr.laplacian(j1) + 0.5 * jexpr.mean(j2)) - jexpr.std(j1)
    for stage in _stages(scheme):
        got = oplib.compute_exprs(e, stage, region=region)
        oracle = (_op(t1, "laplacian", stage, region=region)
                  + 0.5 * _op(t2, "mean", stage, region=region)
                  - _op(t1, "std", stage, region=region))
        _bitwise(oracle, got, (scheme, stage, region))
        _close(_jexprs(je, stage, region=region), got, 1e-5,
               (scheme, stage, region), atol=1e-5)


@pytest.mark.parametrize("scheme", ALL)
@pytest.mark.parametrize("region", [None, REGION], ids=["full", "region"])
def test_stencil_roots_bitwise_against_reference(scheme, region, field_2d):
    """Single-stencil roots (one rounding from an integer plane) equal the
    reference's expression query bitwise at every feasible stage."""
    ju, tu = _pair(scheme, field_2d[:N0, :N1], rel_eb=1e-3)
    jv, tv = _pair(scheme, field_2d[40:40 + N0, 10:10 + N1], rel_eb=1e-3)
    for stage in _stages(scheme):
        got = query(exprs=[expr.laplacian(tu), expr.derivative(tv, axis=1),
                           expr.gradient(tu)], stage=stage, region=region)
        want = janalytics.query(
            exprs=[jexpr.laplacian(ju), jexpr.derivative(jv, axis=1),
                   jexpr.gradient(ju)], stage=JStage(int(stage)),
            region=region)
        for w, g in zip(want.values, got.values, strict=True):
            _bitwise(w, g, (scheme, stage, region))


@pytest.mark.parametrize("scheme", ND)
@pytest.mark.parametrize("region", [None, REGION], ids=["full", "region"])
def test_store_seeded_expression_bit_identical(scheme, region, field_2d):
    """Store-backed id leaves: the warm (seeded) run is bitwise the cold run
    and the storeless lowering; planning sees the residency; the stage, hit
    and miss counts equal the reference's for the same two queries."""
    ju, tu = _pair(scheme, field_2d[:N0, :N1], rel_eb=1e-3)
    jv, tv = _pair(scheme, field_2d[40:40 + N0, 10:10 + N1], rel_eb=1e-3)
    store = FieldStore(cache_bytes=1 << 30)
    store.put("u", tu)
    store.put("v", tv)
    vort = expr.sub(expr.derivative("v", axis=0), expr.derivative("u", axis=1))
    engine = BatchedAnalytics()
    cold = query(exprs=[vort], store=store, region=region, engine=engine)
    warm = query(exprs=[vort], store=store, region=region, engine=engine)
    _bitwise(cold.values[0], warm.values[0])
    assert warm.store_hits >= 2 and warm.store_misses == 0
    assert store.is_resident("u", cold.stages[0], region=region,
                             closure=expr.leaf_closure(
                                 expr.analyze([vort]), 1,
                                 tu.scheme, cold.stages[0]))
    ref = oplib.compute_exprs(
        expr.sub(expr.derivative(tv, axis=0), expr.derivative(tu, axis=1)),
        cold.stages[0], region=region)
    _bitwise(ref, cold.values[0])

    from repro.analytics.engine import BatchedAnalytics as JEngine
    from repro.store import FieldStore as JFieldStore
    jstore = JFieldStore(cache_bytes=1 << 30)
    jstore.put("u", ju)
    jstore.put("v", jv)
    jvort = jexpr.sub(jexpr.derivative("v", axis=0),
                      jexpr.derivative("u", axis=1))
    jeng = JEngine()
    jcold = janalytics.query(exprs=[jvort], store=jstore, region=region,
                             engine=jeng)
    jwarm = janalytics.query(exprs=[jvort], store=jstore, region=region,
                             engine=jeng)
    for j, t in ((jcold, cold), (jwarm, warm)):
        assert [int(s) for s in j.stages] == [int(s) for s in t.stages]
        assert (j.store_hits, j.store_misses, j.n_dispatches, j.n_batches) \
            == (t.store_hits, t.store_misses, t.n_dispatches, t.n_batches)
    _close(jcold.values[0], cold.values[0], 1e-6, atol_rel=1e-6)
    assert engine.cache_size == jeng.cache_size


# ===========================================================================
# shared prelude: exactly one StageContext (stage reconstruction) per leaf
# ===========================================================================

def test_shared_prelude_one_context_per_leaf(monkeypatch, field_2d):
    """Five consumers over two leaves build exactly two StageContexts."""
    _, c1 = _pair("hszp_nd", field_2d[:N0, :N1], rel_eb=1e-3)
    _, c2 = _pair("hszp_nd", field_2d[60:60 + N0, 5:5 + N1], rel_eb=1e-3)
    built = []
    real = oplib.StageContext

    class Counting(real):
        def __init__(self, *a, **k):
            built.append(1)
            super().__init__(*a, **k)

    monkeypatch.setattr(oplib, "StageContext", Counting)
    e1 = expr.laplacian(c1) - expr.scale(expr.mean(c1), 2.0)
    e2 = expr.std(c1) + expr.laplacian(c2)
    out = oplib.compute_exprs([e1, e2], Stage.Q)
    assert len(built) == 2  # two distinct leaves, five op applications
    monkeypatch.setattr(oplib, "StageContext", real)
    oracle = oplib.compute(c1, ["laplacian", "mean", "std"], Stage.Q)
    oracle2 = oplib.compute(c2, "laplacian", Stage.Q)
    _bitwise(oracle["laplacian"] - 2.0 * oracle["mean"], out[0])
    _bitwise(oracle["std"] + oracle2["laplacian"], out[1])


def test_query_expression_single_dispatch(field_2d):
    """query(exprs=[...]) issues exactly one program call for a multi-root
    DAG, reuses the program on re-query, and counts like the reference."""
    j1, c1 = _pair("hszp_nd", field_2d[:N0, :N1], rel_eb=1e-3)
    j2, c2 = _pair("hszp_nd", field_2d[30:30 + N0, 8:8 + N1], rel_eb=1e-3)
    engine = BatchedAnalytics()
    roots = [expr.laplacian(c1) - expr.laplacian(c2),
             expr.mean(c1) + expr.mean(c2)]
    res = query(exprs=roots, engine=engine)
    assert res.n_dispatches == 1 and res.n_batches == 1
    assert engine.cache_size == 1
    again = query(exprs=roots, engine=engine)
    assert engine.cache_size == 1  # same canonical program: cache hit
    for a, b in zip(res.values, again.values):
        _bitwise(a, b)
    jroots = [jexpr.laplacian(j1) - jexpr.laplacian(j2),
              jexpr.mean(j1) + jexpr.mean(j2)]
    jres = janalytics.query(exprs=jroots)
    assert (jres.n_dispatches, jres.n_batches) == (1, 1)
    assert [int(s) for s in jres.stages] == [int(s) for s in res.stages]
    _close(jres.values[0], res.values[0], 1e-6, atol_rel=1e-6)
    _close(jres.values[1], res.values[1], 1e-5)


def test_fresh_program_that_raises_is_evicted(field_2d):
    """An infeasible explicit stage raises from the ops and leaves no program
    in the cache (as the reference's engine evicts a fresh entry)."""
    _, c = _pair("hszp", field_2d[:N0, :N1], rel_eb=1e-3)
    engine = BatchedAnalytics()
    program = expr.analyze([expr.laplacian(c)])
    with pytest.raises(UnsupportedStageError, match="stencil"):
        engine.run_expr(program, [c], (Stage.P,))
    assert engine.cache_size == 0
    with pytest.raises(UnsupportedStageError):
        engine.run([c], "laplacian", Stage.P)
    assert engine.cache_size == 0


# ===========================================================================
# canonicalization: CSE, commuted adds, structural keys
# ===========================================================================

def test_cse_one_postlude_per_distinct_application(field_2d):
    _, c = _pair("hszp_nd", field_2d[:N0, :N1], rel_eb=1e-3)
    e = expr.laplacian(c) + expr.laplacian(c)
    program = expr.analyze([e])
    assert len(program.leaves) == 1
    assert len(program.op_nodes) == 1  # identical applications deduplicate
    got = oplib.compute_exprs(e, Stage.Q)
    _bitwise(2.0 * _op(c, "laplacian", Stage.Q), got)


def test_add_commutes_into_one_program_key(field_2d):
    _, c1 = _pair("hszp_nd", field_2d[:N0, :N1], rel_eb=1e-3)
    _, c2 = _pair("hszp_nd", field_2d[10:10 + N0, 4:4 + N1], rel_eb=1e-3)
    ab = expr.analyze([expr.add(expr.mean(c1), expr.std(c2))])
    ba = expr.analyze([expr.add(expr.std(c2), expr.mean(c1))])
    assert ab.key == ba.key  # IEEE add commutes bitwise: share the program
    s_ab = expr.analyze([expr.sub(expr.mean(c1), expr.std(c2))])
    s_ba = expr.analyze([expr.sub(expr.std(c2), expr.mean(c1))])
    assert s_ab.key != s_ba.key  # sub does not


def _dag_pairs(ju, jv, tu, tv):
    """The same DAGs in both packages (field leaves whose canonical order
    does not depend on object identity, and id leaves)."""
    out = []
    for m, (a, b) in ((jexpr, (ju, jv)), (expr, (tu, tv))):
        out.append([
            [m.add(m.mean(a), m.std(b))],
            [m.add(m.std(b), m.mean(a))],
            [m.sub(m.laplacian(a), m.scale(m.mean(b), -2.0))],
            [m.curl((a, b)), m.divergence((a, b)),
             m.laplacian(a) - m.laplacian(b),
             m.scale(m.mean(a), 2.0) + m.std(b)],
            [m.add(m.laplacian("u"), m.laplacian("v"))],
            [m.add(m.laplacian("v"), m.laplacian("u")),
             m.derivative("u", axis=1) - m.derivative("u", axis=0)],
            [m.curl(("u", "v")) + m.mean("w"), m.std("w")],
        ])
    return list(zip(*out))


def test_program_keys_and_structure_match_reference(field_2d):
    """For the same DAG both packages give the same program key, slot
    count, CSE'd applications, serializations and components."""
    ju, tu = _pair("hszp_nd", field_2d[:N0, :N1], rel_eb=1e-3)
    jv, tv = _pair("hszp_nd", field_2d[10:10 + N0, 4:4 + N1], rel_eb=1e-3)
    for jroots, troots in _dag_pairs(ju, jv, tu, tv):
        jp, tp = jexpr.analyze(jroots), expr.analyze(troots)
        assert jp.key == tp.key
        assert len(jp.leaves) == len(tp.leaves)
        assert [(n.name, n.axis) for n in jp.op_nodes] == [
            (n.name, n.axis) for n in tp.op_nodes]
        assert jp.op_slots == tp.op_slots
        assert [jp.serial(r) for r in jroots] == [tp.serial(r) for r in troots]
        assert (jp.leaf_component, jp.root_component, jp.n_components) == (
            tp.leaf_component, tp.root_component, tp.n_components)
        for slot in range(len(tp.leaves)):
            assert jp.leaf_consumers(slot) == tp.leaf_consumers(slot)


# ===========================================================================
# joint DAG planning
# ===========================================================================

def test_plan_expr_joint_intersection(field_2d):
    """A component joining a stencil (②③④ on nd) with a mean picks one
    stage feasible for both; independent components plan independently;
    the plan equals the reference's."""
    jnd, nd = _pair("hszp_nd", field_2d[:N0, :N1], rel_eb=1e-3)
    jflat, flat = _pair("hszp", field_2d[:N0, :N1], rel_eb=1e-3)
    joined = expr.laplacian(nd) + expr.mean(nd)
    alone = expr.mean(flat)
    program = expr.analyze([joined, expr.add(alone, alone)])
    plan = plan_expr(program, [nd, flat])
    assert isinstance(plan, ExprPlan) and len(plan.stages) == 2
    s_joined = plan.stages[program.root_component[0]]
    assert s_joined in (Stage.P, Stage.Q, Stage.F)  # never ① (stencil)
    jprogram = jexpr.analyze([jexpr.laplacian(jnd) + jexpr.mean(jnd),
                              jexpr.add(jexpr.mean(jflat), jexpr.mean(jflat))])
    jplan = janalytics.plan_expr(jprogram, [jnd, jflat])
    assert [int(s) for s in jplan.stages] == [int(s) for s in plan.stages]
    with pytest.raises(UnsupportedStageError, match="stencil|stage"):
        oplib.compute_exprs(expr.laplacian(flat), Stage.P)


def test_plan_expr_explicit_stage_validates(field_2d):
    jc, c = _pair("hszp", field_2d[:N0, :N1], rel_eb=1e-3)
    program = expr.analyze([expr.laplacian(c) + expr.mean(c)])
    jprogram = jexpr.analyze([jexpr.laplacian(jc) + jexpr.mean(jc)])
    with pytest.raises(UnsupportedStageError):
        plan_expr(program, [c], stage=Stage.P)  # flat scheme: no ② stencils
    from repro.core import UnsupportedStageError as JUnsupported
    with pytest.raises(JUnsupported):
        janalytics.plan_expr(jprogram, [jc], stage=JStage.P)
    assert plan_expr(program, [c], stage=Stage.Q).stages == (Stage.Q,)


# ===========================================================================
# validation errors
# ===========================================================================

def test_bare_leaf_root_rejected(field_2d):
    _, c = _pair("hszp_nd", field_2d[:N0, :N1], rel_eb=1e-3)
    with pytest.raises(TypeError, match="bare leaf"):
        expr.analyze([expr.leaf(c)])


def test_op_on_op_rejected(field_2d):
    _, c = _pair("hszp_nd", field_2d[:N0, :N1], rel_eb=1e-3)
    with pytest.raises(TypeError, match="add/sub/scale"):
        expr.op("mean", expr.laplacian(c))


def test_cycle_detected(field_2d):
    _, c = _pair("hszp_nd", field_2d[:N0, :N1], rel_eb=1e-3)
    a = expr.mean(c) + expr.std(c)
    b = expr.scale(a, 2.0)
    object.__setattr__(a, "a", b)  # forge a cycle past immutability
    with pytest.raises(ValueError, match="cycle"):
        expr.analyze([b])


def test_nodes_are_immutable(field_2d):
    _, c = _pair("hszp_nd", field_2d[:N0, :N1], rel_eb=1e-3)
    e = expr.mean(c)
    with pytest.raises(AttributeError, match="immutable"):
        e.name = "std"


def test_duplicate_bundle_ids_rejected():
    with pytest.raises(ValueError, match="duplicate"):
        expr.divergence(("u", "u"))


def _raised(fn):
    """``(exception type name, message)`` of ``fn()``, or its value."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)


def test_temporal_ops_and_streams_wait_for_the_stream_slice():
    """The calls that waited for the stream slice now answer as the
    reference's do: temporal op names build nodes with the reference's
    serialization, mixed arities and spatial ops over a stream-like leaf
    (``layout_sig``) raise the reference's exceptions — from an op, from a
    store id in an expression and from the flat form alike."""
    for name in ("tdelta", "tmean", "tmin", "tmax", "tstd"):
        assert name in joplib.TEMPORAL_OPS
        node, jnode = expr.op(name, "s"), jexpr.op(name, "s")
        assert (node.spec.arity, node.spec.category) == (
            jnode.spec.arity, jnode.spec.category) == ("temporal", "temporal")
        assert expr.analyze([node]).key == jexpr.analyze([jnode]).key
        assert getattr(expr, name)("s").name == name
    for pkg in (oplib, joplib):
        with pytest.raises(ValueError, match="different arities"):
            pkg.canonical_ops(["mean", "tdelta"])

    class Stream:
        def layout_sig(self):
            return ("stream",)

    got, want = _raised(lambda: expr.mean(Stream())), _raised(
        lambda: jexpr.mean(Stream()))
    assert got[0] == want[0] == "TypeError" and "temporal" in got[1]

    class StreamStore:
        stats = None

        def get(self, fid):
            return Stream()

    for fn in (lambda q, e: q(exprs=[e.mean("s")], store=StreamStore()),
               lambda q, e: q(["s"], "mean", store=StreamStore())):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            got = _raised(lambda: fn(query, expr))
            want = _raised(lambda: fn(janalytics.query, jexpr))
        assert got[0] == want[0] == "TypeError"
        assert ("spatial" in got[1]) and ("spatial" in want[1])


def test_unknown_op_and_bad_scale(field_2d):
    _, c = _pair("hszp_nd", field_2d[:N0, :N1], rel_eb=1e-3)
    with pytest.raises(ValueError, match="unknown"):
        expr.op("median", c)
    with pytest.raises(TypeError):
        expr.scale(expr.mean(c), True)
    with pytest.raises(TypeError, match="tuple of components"):
        expr.gradient(c) + expr.mean(c)
    with pytest.raises(TypeError, match="component bundle"):
        expr.curl(c)
    with pytest.raises(TypeError, match="single Compressed/Encoded"):
        expr.mean((c, c))


def test_shape_mismatch_rejected(field_2d):
    _, c1 = _pair("hszp_nd", field_2d[:N0, :N1], rel_eb=1e-3)
    _, c2 = _pair("hszp_nd", field_2d[:32, :32], rel_eb=1e-3)
    e = expr.laplacian(c1) + expr.laplacian(c2)
    with pytest.raises(ValueError, match="shapes"):
        oplib.compute_exprs(e, Stage.Q)


def test_ids_need_a_store(field_2d):
    with pytest.raises(ValueError, match="store"):
        oplib.compute_exprs(expr.mean("u"), Stage.Q)
    with pytest.raises(ValueError, match="no store"):
        query(exprs=[expr.mean("u")])


# ===========================================================================
# temporal expressions and counter parity (the stream slice)
# ===========================================================================

def test_mixed_temporal_spatial_consumers_rejected():
    for pkg in (expr, jexpr):
        with pytest.raises(TypeError, match="temporal"):
            pkg.analyze([pkg.add(pkg.tmean("s"), pkg.mean("s"))])


def _streams(scheme, seed, slabs=3, k=4, n=24):
    """(reference stream, port stream on the CPU) of the same numpy slabs."""
    from repro.stream import TemporalField as JTF
    from repro_torch.stream import TemporalField

    rng = np.random.default_rng(seed)
    jt = JTF(scheme, abs_eb=0.01)
    tf = TemporalField(scheme, abs_eb=0.01, device="cpu")
    for _ in range(slabs):
        d = rng.random((k, n, n)).astype(np.float32)
        jt.append(d)
        tf.append(d)
    return jt, tf


def test_temporal_expression_matches_flat():
    """tmean - tdelta as one expression equals the flat op set's values
    composed, and the reference's (bitwise here: tmean's two roundings and
    tdelta's one land identically on this stream)."""
    from repro.stream.query import query_temporal as jquery_temporal
    from repro_torch.stream.query import query_temporal

    jt, tf = _streams("hszp_nd", 7)
    res = query(exprs=[expr.tmean(tf) - expr.tdelta(tf)])
    flat = query_temporal([tf], ["tmean", "tdelta"])
    np.testing.assert_array_equal(
        res.values[0].numpy(),
        (flat.values[0]["tmean"] - flat.values[0]["tdelta"]).numpy())
    jres = janalytics.query(exprs=[jexpr.tmean(jt) - jexpr.tdelta(jt)])
    np.testing.assert_allclose(res.values[0].numpy(),
                               np.asarray(jres.values[0]), rtol=1e-6,
                               atol=1e-6)
    # one summary per stream slot even with two consumers
    assert res.n_dispatches == jres.n_dispatches >= 2
    jflat = jquery_temporal([jt], ["tmean", "tdelta"])
    np.testing.assert_array_equal(flat.values[0]["tdelta"].numpy(),
                                  np.asarray(jflat.values[0]["tdelta"]))


def test_temporal_counters_uniform_with_spatial():
    """query_temporal reports dispatch / batch accounting like the spatial
    path, as the reference's does: n_dispatches counts program calls
    (summaries, merges, postludes), n_batches layout groups."""
    from repro.stream.query import query_temporal as jquery_temporal
    from repro_torch.stream.query import query_temporal

    jt1, t1 = _streams("hszp_nd", 8)
    jt2, t2 = _streams("hszp_nd", 9)  # same layout: one batch group
    res = query_temporal([t1, t2], "tmean")
    jres = jquery_temporal([jt1, jt2], "tmean")
    assert res.n_batches == jres.n_batches == 1
    # per stream: 1 batched summarize + 2 merges + 1 postlude = 4
    assert res.n_dispatches == jres.n_dispatches == 8
    assert res.store_hits == 0 and res.store_misses == 0
    jt3, t3 = _streams("hszx_nd", 10)  # another scheme: a second group
    assert query_temporal([t1, t3], "tmean").n_batches == jquery_temporal(
        [jt1, jt3], "tmean").n_batches == 2


def test_cross_stream_delta_store_backed():
    """tmean(a) - tmean(b) by id through a StreamFieldStore equals the two
    store-backed flat queries composed, bitwise; the reference's within the
    tmean tolerance."""
    from repro.stream import StreamFieldStore as JStore
    from repro.stream import TemporalField as JTF
    from repro_torch.core import error_analysis
    from repro_torch.stream import StreamFieldStore, TemporalField
    from repro_torch.stream.query import query_temporal

    rng = np.random.default_rng(9)
    store = StreamFieldStore(cache_bytes=1 << 30)
    jstore = JStore(cache_bytes=1 << 30)
    for fid in ("a", "b"):
        store.put_temporal(fid, TemporalField("hszp_nd", abs_eb=0.01,
                                              device="cpu"))
        jstore.put_temporal(fid, JTF("hszp_nd", abs_eb=0.01))
        for _ in range(3):
            d = rng.random((4, 24, 24)).astype(np.float32)
            store.append(fid, d)
            jstore.append(fid, d)
    res = query(exprs=[expr.sub(expr.tmean("a"), expr.tmean("b"))],
                store=store)
    a = query_temporal(["a"], "tmean", store=store).values[0]
    b = query_temporal(["b"], "tmean", store=store).values[0]
    np.testing.assert_array_equal(res.values[0].numpy(), (a - b).numpy())
    jres = janalytics.query(
        exprs=[jexpr.sub(jexpr.tmean("a"), jexpr.tmean("b"))], store=jstore)
    tol = sum(error_analysis.temporal_round_bound(
        "tmean", store.temporal_summary(f), store.get(f).eps).numpy()
        for f in ("a", "b"))
    assert np.all(np.abs(res.values[0].numpy().astype(np.float64)
                         - np.asarray(jres.values[0], np.float64))
                  <= tol + 4 * np.finfo(np.float32).eps
                  * np.abs(res.values[0].numpy()))


def test_temporal_and_spatial_roots_in_one_batch(field_2d):
    """A batch mixing a temporal root and a spatial root: the spatial DAG
    runs as one program, the temporal value joins through ``precomputed``;
    each root equals its single query, and ``compute_exprs`` agrees."""
    from repro_torch.stream.query import query_temporal

    _, tf = _streams("hszx_nd", 11)
    _, c = _pair("hszx_nd", field_2d[:N0, :N1], rel_eb=1e-3)
    roots = [expr.tmax(tf) - expr.tmin(tf), expr.laplacian(c)]
    res = query(exprs=roots, stage=Stage.Q)
    flat = query_temporal([tf], ["tmax", "tmin"], Stage.Q).values[0]
    np.testing.assert_array_equal(res.values[0].numpy(),
                                  (flat["tmax"] - flat["tmin"]).numpy())
    np.testing.assert_array_equal(
        res.values[1].numpy(),
        oplib.compute(c, "laplacian", Stage.Q)["laplacian"].numpy())
    core = oplib.compute_exprs(roots, Stage.Q)
    for g, w in zip(core, res.values):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    with pytest.raises(ValueError, match="precomputed"):
        expr.lower(expr.analyze([expr.tmean(tf)]), [tf], (Stage.Q,))


# ===========================================================================
# registry hygiene and the deprecated flat spellings
# ===========================================================================

def test_register_op_collision_guard():
    spec = oplib.OpSpec("mean", "field", "statistic",
                        lambda s: (Stage.Q, Stage.F))
    with pytest.raises(ValueError, match="collision.*mean"):
        oplib.register_op(spec)


def test_mixed_arity_error_names_offenders():
    with pytest.raises(ValueError) as ei:
        oplib.canonical_ops(["mean", "curl"])
    msg = str(ei.value)
    assert "different arities" in msg
    assert "mean (field)" in msg and "curl (vector)" in msg


def test_query_op_spelling_deprecated_but_identical(field_2d):
    _, c = _pair("hszp_nd", field_2d[:N0, :N1], rel_eb=1e-3)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        old = query([c], "mean")
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    ref = _query_opset([c], "mean")
    _bitwise(ref.values[0], old.values[0])
    assert (old.n_batches, old.n_dispatches) == (ref.n_batches,
                                                 ref.n_dispatches)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        alias = query([c], ops=["mean", "std"])
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    ref2 = _query_opset([c], ["mean", "std"])
    _bitwise(ref2.values[0]["std"], alias.values[0]["std"])
    with pytest.raises(TypeError, match="op= or ops="):
        query([c], "mean", ops=["std"])
    with pytest.raises(TypeError, match="expression form"):
        query([c], exprs=[expr.mean(c)])
    with pytest.raises(TypeError, match="needs exprs="):
        query([c])


# ===========================================================================
# property test: random small DAGs == composed single-op oracle, both packages
# ===========================================================================

_leaf_ops = st.sampled_from(["mean", "std", "laplacian"])


@st.composite
def _dags(draw):
    """A random expression tree over up to 3 leaves (by index) with up to
    depth-3 combinators; returns a spec the test folds into an Expr."""
    n_leaves = draw(st.integers(1, 3))

    def node(depth):
        if depth >= 3 or draw(st.booleans()):
            return ("op", draw(_leaf_ops), draw(st.integers(0, n_leaves - 1)))
        kind = draw(st.sampled_from(["add", "sub", "scale"]))
        if kind == "scale":
            alpha = draw(st.sampled_from([-2.0, 0.5, 1.0, 3.0]))
            return ("scale", alpha, node(depth + 1))
        return (kind, node(depth + 1), node(depth + 1))

    return n_leaves, node(0)


@functools.lru_cache(maxsize=1)
def _dag_leaves(data_bytes: bytes):
    data = np.frombuffer(data_bytes, np.float32).reshape(181, 97)
    return [_pair("hszp_nd", data[o:o + 32, o:o + 32], rel_eb=1e-3)
            for o in (0, 16, 48)]


@settings(max_examples=20, deadline=None)
@given(spec=_dags())
def test_random_dag_matches_composed_oracle(field_2d, spec):
    n_leaves, tree = spec
    pairs = _dag_leaves(np.ascontiguousarray(field_2d).tobytes())[:n_leaves]

    def build(m, comps, t):
        if t[0] == "op":
            return m.op(t[1], comps[t[2]])
        if t[0] == "scale":
            return m.scale(build(m, comps, t[2]), t[1])
        return (m.add if t[0] == "add" else m.sub)(build(m, comps, t[1]),
                                                   build(m, comps, t[2]))

    def oracle(t):
        if t[0] == "op":
            return _op(pairs[t[2]][1], t[1], Stage.Q).numpy()
        if t[0] == "scale":
            return oracle(t[2]) * np.float32(t[1])
        a, b = oracle(t[1]), oracle(t[2])
        return a + b if t[0] == "add" else a - b

    got = oplib.compute_exprs(build(expr, [p[1] for p in pairs], tree),
                              Stage.Q).numpy()
    ref = np.asarray(joplib.compute_exprs(
        build(jexpr, [p[0] for p in pairs], tree), JStage.Q))
    np.testing.assert_allclose(got, oracle(tree), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
