"""The port's planner and batched engine (``repro_torch.analytics``) against
the JAX reference (``repro.analytics``).

The same numpy fields are compressed by the reference and carried into the
port with ``convert.from_arrays``.  What is held, with its tolerance:

* the feasibility matrix, auto and explicit plans, ``CostModel`` choices
  from the same CSV rows, ``n_batches`` / ``n_dispatches`` after the same
  query sequence: **exactly** the reference's;
* inside the port, **bitwise**: a batched ``run`` equals the per-field
  ``homomorphic`` calls, leaf for leaf, for scalar, vector and ``Encoded``
  fields at every feasible stage; back-to-back calls on one engine that
  differ in one input each equal a fresh engine's call (the port keeps no
  program cache, so nothing of one call may reach the next);
* against the reference's batched query: derivative / gradient / laplacian
  **bitwise**; divergence / curl ``rtol=1e-6``, ``atol=1e-6·max|ref|``;
  mean / std ``rtol=1e-5`` or half of the paper's bias bound (1e-3 of it
  where the bound is eps) — the tolerances of ``tests/test_torch_slice.py``.

The reference's own matrix test pins its planner to the ops' raise/no-raise
behaviour; the port's runs the same cells on the port's ops.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import analytics as janalytics
from repro.core import Scheme as JScheme
from repro.core import Stage as JStage
from repro.core import by_name as jax_by_name
from repro_torch import analytics, convert
from repro_torch.core import Stage, UnsupportedStageError, error_analysis
from repro_torch.core import homomorphic as H
from repro_torch.core.stages import LEAVES
from repro_torch.kernels import ops
from repro_torch.store import materialize

ROOT = pathlib.Path(__file__).resolve().parents[1]
ALL = ["hszp", "hszx", "hszp_nd", "hszx_nd"]
ND = ["hszp_nd", "hszx_nd"]
UNIVARIATE = ["mean", "std", "derivative", "gradient", "laplacian"]


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


def _compress_many(scheme, n, shape=(37, 53), rel_eb=1e-3, seed=0):
    """``n`` random fields as (reference fields, port fields)."""
    rng = np.random.default_rng(seed)
    comp = jax_by_name(scheme)
    js = [comp.compress(jnp.asarray(rng.normal(0, 1, shape).astype(np.float32)),
                        rel_eb=rel_eb) for _ in range(n)]
    return js, [to_port(c) for c in js]


def _apply(op, c, stage, axis=0):
    if op == "mean":
        return H.mean(c, stage)
    if op == "std":
        return H.std(c, stage)
    if op == "derivative":
        return H.derivative(c, stage, axis)
    if op == "gradient":
        return H.gradient(c, stage)
    if op == "laplacian":
        return H.laplacian(c, stage)
    if op == "divergence":
        return H.divergence(list(c), stage)
    return H.curl(list(c), stage)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tup(x):
    return x if isinstance(x, tuple) else (x,)


def _bitwise(want, got, what=""):
    assert len(_tup(want)) == len(_tup(got)), what
    for w, g in zip(_tup(want), _tup(got)):
        w, g = _np(w), _np(g)
        assert (w.shape, w.dtype) == (g.shape, g.dtype), what
        assert w.tobytes() == g.tobytes(), what


def _match_reference(op, want, got, field, stage, what):
    """The slice tolerances: stencils bitwise, div/curl rtol 1e-6, stats
    rtol 1e-5 or half the bias bound (1e-3 of it where it is eps)."""
    if op in ("mean", "std"):
        w, g = float(_np(want)), float(_np(got))
        bound = (error_analysis.mean_bias_bound if op == "mean"
                 else error_analysis.std_bias_bound)(field, stage)
        eps = float(field.eps.item())
        tol = max(1e-5 * abs(w), (1e-3 if bound >= eps else 0.5) * bound)
        assert abs(g - w) <= tol, (what, abs(g - w), tol)
    elif op in ("divergence", "curl"):
        for w, g in zip(_tup(want), _tup(got), strict=True):
            w, g = _np(w), _np(g)
            np.testing.assert_allclose(g, w, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(w).max()),
                                       err_msg=what)
    else:
        _bitwise(want, got, what)


def _jstage(s):
    return JStage(int(s))


# -- feasibility matrix: planner pinned to op behaviour ------------------------

@pytest.mark.parametrize("scheme", ALL)
@pytest.mark.parametrize("op", analytics.OPS)
@pytest.mark.parametrize("stage", list(Stage), ids=lambda s: s.name)
def test_feasibility_matrix_matches_ops(scheme, op, stage, field_2d):
    """Every Table I cell: the port's planner says feasible <=> the port's
    op does not raise, and the row equals the reference's."""
    jrow = janalytics.FEASIBILITY[(JScheme(scheme), op)]
    row = analytics.FEASIBILITY[(analytics.planner.Scheme(scheme), op)]
    assert [int(s) for s in jrow] == [int(s) for s in row]
    comp = jax_by_name(scheme)
    if op in analytics.MULTIVARIATE:
        item = (to_port(comp.compress(jnp.asarray(field_2d), rel_eb=1e-3)),
                to_port(comp.compress(jnp.asarray(field_2d[::-1].copy()),
                                      rel_eb=1e-3)))
    else:
        item = to_port(comp.compress(jnp.asarray(field_2d), rel_eb=1e-3))
    s = item[0].scheme if isinstance(item, tuple) else item.scheme
    assert analytics.is_feasible(s, op, stage) == (int(stage) in
                                                   [int(x) for x in jrow])
    if analytics.is_feasible(s, op, stage):
        out = _apply(op, item, stage)  # must not raise
        assert all(bool(torch.isfinite(x).all()) for x in _tup(out))
    else:
        with pytest.raises(UnsupportedStageError):
            _apply(op, item, stage)


def test_matrix_holds_exactly_the_spatial_rows():
    """The port's matrix is the reference's whole matrix: the spatial rows
    and, since the stream slice, the temporal ones."""
    assert {(k[0].value, k[1]): [int(s) for s in v]
            for k, v in janalytics.FEASIBILITY.items()} == {
        (k[0].value, k[1]): [int(s) for s in v]
        for k, v in analytics.FEASIBILITY.items()}
    assert analytics.OPS == janalytics.OPS
    assert analytics.MULTIVARIATE == janalytics.MULTIVARIATE
    assert analytics.TEMPORAL == janalytics.TEMPORAL == (
        "tdelta", "tmean", "tmin", "tmax", "tstd")
    # the reference's jit-cache key builder has no counterpart: the port
    # keeps no program cache
    assert set(analytics.__all__) == set(janalytics.__all__) - {"batch_key"}


@pytest.mark.parametrize("scheme", ALL)
@pytest.mark.parametrize("op", analytics.OPS)
def test_auto_stage_never_raises(scheme, op, field_2d):
    """stage="auto" always resolves to a stage the op supports, the
    reference's."""
    s = analytics.planner.Scheme(scheme)
    stage = analytics.plan_stage(s, op, "auto")
    assert stage == analytics.feasible_stages(s, op)[0]
    assert int(stage) == int(janalytics.plan_stage(JScheme(scheme), op))
    c = to_port(jax_by_name(scheme).compress(jnp.asarray(field_2d),
                                             rel_eb=1e-3))
    item = (c, c) if op in analytics.MULTIVARIATE else c
    _apply(op, item, stage)  # must not raise


def test_explicit_infeasible_stage_raises():
    s = analytics.planner.Scheme
    with pytest.raises(UnsupportedStageError):
        analytics.plan_stage(s.HSZP, "mean", Stage.M)
    with pytest.raises(UnsupportedStageError):
        analytics.plan_stage(s.HSZP, "derivative", "P")
    assert analytics.plan_stage(s.HSZP_ND, "derivative", "p") == Stage.P
    with pytest.raises(ValueError, match="unknown stage"):
        analytics.as_stage("auto-ish")


# -- batch validation: one layout and one device per batch ----------------------

def _mismatched_pair(kind):
    """Two reference fields that may not share a batch, by ``kind``."""
    comp = jax_by_name("hszp_nd")
    a = comp.compress(jnp.zeros((32, 32)), abs_eb=1e-3)
    if kind == "shape":
        return a, comp.compress(jnp.zeros((16, 16)), abs_eb=1e-3)
    if kind == "scheme":
        return a, jax_by_name("hszx_nd").compress(jnp.zeros((32, 32)),
                                                  abs_eb=1e-3)
    if kind == "container":
        return a, comp.encode(a)
    return comp.encode(a, bits=3), comp.encode(a, bits=5)     # packed width


@pytest.mark.parametrize("kind", ["shape", "scheme", "container", "bits"])
@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
def test_run_rejects_a_mixed_batch_as_the_reference(kind, vector):
    """A batch whose fields differ in layout raises the reference's
    ``batch_stack`` error, in the engine of both packages; for a vector op
    set the mismatch sits in one component."""
    ja, jb = _mismatched_pair(kind)
    msg = "cannot stack fields with different layouts"
    if vector:
        jbatch, op = [(ja, ja), (ja, jb)], "curl"
    else:
        jbatch, op = [ja, jb], "mean"
    tbatch = [tuple(map(to_port, x)) if vector else to_port(x)
              for x in jbatch]
    with pytest.raises(ValueError, match=msg):
        janalytics.BatchedAnalytics().run(jbatch, op, JStage.Q)
    with pytest.raises(ValueError, match=msg):
        analytics.BatchedAnalytics().run(tbatch, op, Stage.Q)


def test_run_rejects_a_batch_across_devices():
    a = to_port(jax_by_name("hszp_nd").compress(jnp.zeros((32, 32)),
                                                abs_eb=1e-3))
    elsewhere = dataclasses.replace(a, **{
        n: torch.empty_like(getattr(a, n), device="meta")
        for n in LEAVES["Compressed"]})
    with pytest.raises(ValueError, match="different devices"):
        analytics.BatchedAnalytics().run([a, elsewhere], "mean", Stage.Q)


# -- batched execution: bit-exact vs per-field calls ---------------------------

@pytest.mark.parametrize("scheme", ALL)
@pytest.mark.parametrize("op", UNIVARIATE)
def test_batched_matches_per_field_all_stages(scheme, op):
    """Batched result == per-field port calls, bitwise, at every feasible
    stage (a batch of 5 is also a padded bucket of 8 in the reference), and
    the reference's batched query within the slice tolerances."""
    js, ts = _compress_many(scheme, 5)
    for stage in analytics.feasible_stages(ts[0].scheme, op):
        res = analytics.query(ts, op, stage=stage)
        jres = janalytics.query(js, op, stage=_jstage(stage))
        assert (res.n_batches, res.n_dispatches) == (jres.n_batches,
                                                     jres.n_dispatches)
        for i, (got, c) in enumerate(zip(res.values, ts)):
            what = f"{scheme} {op}@{stage.name} field {i}"
            _bitwise(_apply(op, c, stage), got, what)
            _match_reference(op, jres.values[i], got, c, stage, what)


@pytest.mark.parametrize("scheme", ND)
@pytest.mark.parametrize("op", ["divergence", "curl"])
def test_batched_multivariate_matches_per_field(scheme, op):
    rng = np.random.default_rng(1)
    comp = jax_by_name(scheme)
    jvecs = [tuple(comp.compress(
        jnp.asarray(rng.normal(0, 1, (40, 44)).astype(np.float32)),
        rel_eb=1e-3) for _ in range(2)) for _ in range(3)]
    tvecs = [tuple(to_port(c) for c in v) for v in jvecs]
    for stage in analytics.feasible_stages(tvecs[0][0].scheme, op):
        res = analytics.query(tvecs, op, stage=stage)
        jres = janalytics.query(jvecs, op, stage=_jstage(stage))
        for i, (got, vec) in enumerate(zip(res.values, tvecs)):
            what = f"{scheme} {op}@{stage.name} vector {i}"
            _bitwise(_apply(op, vec, stage), got, what)
            _match_reference(op, jres.values[i], got, vec[0], stage, what)


@pytest.mark.parametrize("scheme", ND)
def test_batched_encoded_fields(scheme):
    """Encoded (bit-packed) fields run batched without pre-decoding, every
    op set at its auto stage equal to per-field calls."""
    comp = jax_by_name(scheme)
    js, _ = _compress_many(scheme, 3, shape=(48, 48))
    bits = max(comp.max_bits(c) for c in js)
    jes = [comp.encode(c, bits=bits) for c in js]
    tes = [to_port(e) for e in jes]
    res = analytics.query(tes, "mean", stage="auto")
    jres = janalytics.query(jes, "mean", stage="auto")
    assert int(res.stages[0]) == int(jres.stages[0])
    assert res.stages[0] == (Stage.M if scheme == "hszx_nd" else Stage.P)
    for got, e in zip(res.values, tes):
        _bitwise(H.mean(e, res.stages[0]), got)
    names = ["mean", "std", "gradient", "laplacian"]
    out = analytics.BatchedAnalytics().run(tes, names, "auto")
    assert list(out) == names
    for i, e in enumerate(tes):
        want = H.compute(e, names, Stage.P)
        for n in names:
            _bitwise(want[n], tuple(x[i] for x in out[n])
                     if isinstance(out[n], tuple) else out[n][i], n)


def test_query_groups_mixed_layouts():
    """One query over heterogeneous layouts: grouped, each at its own
    stage, results in input order; counts are the reference's."""
    jnd, nd = _compress_many("hszx_nd", 2, shape=(40, 40))
    joned, oned = _compress_many("hszp", 2, shape=(300,), seed=3)
    res = analytics.query([nd[0], oned[0], nd[1], oned[1]], "mean")
    jres = janalytics.query([jnd[0], joned[0], jnd[1], joned[1]], "mean")
    assert res.n_batches == jres.n_batches == 2
    assert res.n_dispatches == jres.n_dispatches
    assert [s.name for s in res.stages] == ["M", "P", "M", "P"]
    for got, c in zip(res.values, [nd[0], oned[0], nd[1], oned[1]]):
        stage = Stage.M if c.scheme.is_blockmean else Stage.P
        _bitwise(H.mean(c, stage), got)


def test_query_unfused_plan_counts_per_op():
    """A per-op plan (explicit mapping of differing stages) runs one call
    per op, and reports the reference's dispatch count."""
    js, ts = _compress_many("hszp_nd", 3)
    stages = {"mean": Stage.P, "laplacian": Stage.Q}
    res = analytics.query(ts, ["mean", "laplacian"], stage="auto")
    jres = janalytics.query(js, ["mean", "laplacian"], stage="auto")
    assert res.n_dispatches == jres.n_dispatches == 1
    out = analytics.BatchedAnalytics().run(ts, ["mean", "laplacian"], stages)
    for i, c in enumerate(ts):
        _bitwise(H.mean(c, Stage.P), out["mean"][i])
        _bitwise(H.laplacian(c, Stage.Q), out["laplacian"][i])


def test_derivative_axis_in_cache_key():
    """Axis 0 and axis 1 on one engine give each axis's own derivative."""
    eng = analytics.BatchedAnalytics()
    _, ts = _compress_many("hszp_nd", 2)
    d0 = eng.run(ts, "derivative", Stage.P, axis=0)
    d1 = eng.run(ts, "derivative", Stage.P, axis=1)
    assert not torch.allclose(d0, d1)
    for axis, got in ((0, d0), (1, d1)):
        for i, c in enumerate(ts):
            _bitwise(H.derivative(c, Stage.P, axis), got[i], f"axis {axis}")


def _same_result(want, got, what=""):
    """Bitwise equality of engine results: tensors, tuples, op dicts."""
    if isinstance(want, dict):
        assert list(want) == list(got), what
        for k in want:
            _bitwise(want[k], got[k], f"{what} {k}")
    else:
        _bitwise(want, got, what)


def _under(mode, call):
    def run(eng):
        with ops.override_mode(mode):
            return call(eng)
    return run


def _back_to_back_calls(case):
    """Engine calls that differ from one another in one input."""
    _, p = _compress_many("hszp_nd", 5)
    if case == "axis":
        return [lambda e, a=a: e.run(p[:2], "derivative", Stage.P, axis=a)
                for a in (0, 1)]
    if case == "region":
        return [lambda e, r=r: e.run(p[:2], ["mean", "laplacian"], Stage.Q,
                                     region=r)
                for r in (None, ((3, 20), (5, 40)), ((10, 30), (0, 53)))]
    if case == "seeded":
        seeds = [materialize(c, Stage.Q) for c in p[:3]]
        return [lambda e: e.run(p[:3], "std", Stage.Q),
                lambda e: e.run(p[:3], "std", Stage.Q, seeds=seeds)]
    if case == "kernel_mode":
        return [_under(m, lambda e: e.run(p[:2], ["mean", "std", "laplacian"],
                                          Stage.P))
                for m in ("off", "on")]
    if case == "batch":
        return [lambda e, n=n: e.run(p[:n], "mean", Stage.P) for n in (1, 3, 5)]
    if case == "op_order":
        return [lambda e, o=o: e.run(p[:2], o, Stage.Q)
                for o in (["std", "mean"], ["mean", "std"],
                          ["laplacian", "std", "mean"])]
    if case == "layout":
        _, x = _compress_many("hszx_nd", 2, seed=4)
        return [lambda e, f=f: e.run(f, ["mean", "std"], Stage.Q)
                for f in (p[:2], x)]
    assert case == "curl"
    _, v3 = _compress_many("hszp_nd", 3, shape=(9, 10, 11), seed=5)
    return [lambda e: e.run([(p[0], p[1]), (p[2], p[3])], "curl", Stage.Q),
            lambda e: e.run([tuple(v3)], "curl", Stage.Q)]


@pytest.mark.parametrize("case", ["axis", "region", "seeded", "kernel_mode",
                                  "batch", "op_order", "layout", "curl"])
def test_back_to_back_calls_equal_a_fresh_engine(case):
    """One engine takes calls that differ in one input; each equals the same
    call on a fresh engine bitwise, so nothing of a call reaches the next."""
    calls = _back_to_back_calls(case)
    eng = analytics.BatchedAnalytics()
    got = [call(eng) for call in calls]
    for i, (call, g) in enumerate(zip(calls, got)):
        _same_result(call(analytics.BatchedAnalytics()), g, f"{case} {i}")


# -- cost model ---------------------------------------------------------------

CSV = "\n".join([
    "name,us_per_call,derived",
    "fig58/Ocean/mean/hszx_nd-m,50.0,GBps=1",
    "fig58/Ocean/mean/hszx_nd-p,5.0,GBps=1",
    "fig58/Ocean/mean/hszx_nd-q,80.0,GBps=1",
    "fig58/Ocean/mean/hszx_nd-f,90.0,GBps=1",
    "fig910/Ocean/deriv/hszp_nd-p,40.0,GBps=1",
    "fig910/Ocean/deriv/hszp_nd-q,20.0,GBps=1",
    "fig910/Ocean/deriv/hszp_nd-f,30.0,GBps=1",
    "fig34/Ocean/hszp_nd-q,15.0,GBps=1",
    "# comment rows and malformed rows are ignored",
    "fig2/Ocean/hszp/eb0.01,0.0,ratio=3",
    "fig58/Ocean/mean/hszx_nd-z,1.0,GBps=1",
    "bogus",
])


def test_cost_model_calibration_changes_plan():
    cm = analytics.CostModel.from_benchmark_csv(CSV)
    jcm = janalytics.CostModel.from_benchmark_csv(CSV)
    s = analytics.planner.Scheme
    assert cm.cost(s.HSZX_ND, "mean", Stage.P) == 5.0
    # calibrated: stage P measured cheaper than the metadata stage
    assert analytics.plan_stage(s.HSZX_ND, "mean", "auto", cm) == Stage.P
    # uncalibrated rows fall back to cheapest-stage-first
    assert analytics.plan_stage(s.HSZX_ND, "std", "auto", cm) == Stage.P
    # a calibrated plan still never picks an infeasible stage
    assert analytics.plan_stage(s.HSZP, "mean", "auto", cm) == Stage.P
    # every choice equals the reference's from the same rows
    assert {(k[0].value, k[1], int(k[2])): v for k, v in cm.table.items()} \
        == {(k[0].value, k[1], int(k[2])): v for k, v in jcm.table.items()}
    assert {(k[0].value, int(k[1])): v for k, v in cm.recon.items()} \
        == {(k[0].value, int(k[1])): v for k, v in jcm.recon.items()}
    for scheme in ALL:
        for op in analytics.OPS:
            for cached in (frozenset(), frozenset({Stage.Q})):
                t = analytics.plan_stage(s(scheme), op, "auto", cm,
                                         cached=cached)
                j = janalytics.plan_stage(
                    JScheme(scheme), op, "auto", jcm,
                    cached=frozenset(_jstage(x) for x in cached))
                assert int(t) == int(j), (scheme, op, cached)
        for ops_ in (["mean", "std"], ["mean", "derivative"],
                     ["derivative", "laplacian"], ["divergence", "curl"]):
            t = analytics.plan_stages(s(scheme), ops_, cost_model=cm)
            j = janalytics.plan_stages(JScheme(scheme), ops_, cost_model=jcm)
            assert (None if t.fused is None else int(t.fused)) == (
                None if j.fused is None else int(j.fused))
            assert [(o, int(x)) for o, x in t.stages] == [
                (o, int(x)) for o, x in j.stages]
            assert t.n_dispatches == j.n_dispatches


def test_cost_model_never_selects_infeasible():
    cm = analytics.CostModel()
    s = analytics.planner.Scheme
    for scheme in ALL:
        for op in analytics.OPS:
            for st in Stage:
                cm.record(s(scheme), op, st, 1e-6 if st == Stage.M else 1e3)
    for scheme in ALL:
        for op in analytics.OPS:
            stage = analytics.plan_stage(s(scheme), op, "auto", cm)
            assert analytics.is_feasible(s(scheme), op, stage)


def test_plan_refresh_is_the_references_arithmetic():
    s = analytics.planner.Scheme
    cm = analytics.CostModel.from_benchmark_csv(CSV)
    jcm = janalytics.CostModel.from_benchmark_csv(CSV)
    for resident in (True, False):
        for model, jmodel in ((cm, jcm), (None, None)):
            t = analytics.plan_refresh(s.HSZP_ND, Stage.Q, 4, model,
                                       summary_resident=resident)
            j = janalytics.plan_refresh(JScheme.HSZP_ND, JStage.Q, 4, jmodel,
                                        summary_resident=resident)
            assert dataclasses.astuple(t) == dataclasses.astuple(j)
    with pytest.raises(ValueError, match="n_slabs"):
        analytics.plan_refresh(s.HSZP_ND, Stage.Q, 0)


def test_analytics_layer_imports_without_jax_or_the_reference():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
            "import repro_torch.analytics, repro_torch.core.expr, "
            "repro_torch.store; print(repro_torch.analytics.__all__[0])")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OPS"
