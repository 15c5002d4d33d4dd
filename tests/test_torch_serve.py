"""The port's serving frontend (``repro_torch.serve``) against the JAX
reference's (``repro.serve``).

Each test is one of the reference's frontend tests, written once as a
scenario over a package namespace (:data:`REF`, :data:`PORT`) and run
against both frontends on the same inputs: the reference's containers
(carried into the port with ``convert.from_arrays``) or the same numpy
slabs.  The port side keeps every assertion of the reference's test; both
sides are then held together:

* the same uids are answered and rejected, rejections with the same
  exception type (``"KeyError: ..."``) and the reference's key words;
* values with the slice tolerances: stencils and ``tdelta`` / ``tmin`` /
  ``tmax`` bitwise; divergence / curl rtol 1e-6, ``atol 1e-6·max|ref|``;
  mean / std rtol 1e-5 or half the paper's bias bound (1e-3 of it where the
  bound is eps); ``tmean`` / ``tstd`` within
  ``error_analysis.temporal_round_bound``; expression roots rtol 1e-5,
  ``atol 1e-5·max|ref|``; result stages equal;
* the ``n_dispatches`` of every group's query equal, step by step.

Mirrored: ``tests/test_analytics.py::test_analytics_frontend_*``,
``tests/test_expr.py::test_serve_*``, ``tests/test_fused.py::
test_serve_multi_op_*``, ``tests/test_region.py::test_serve_*``,
``tests/test_store.py::test_serve_*`` and ``tests/test_stream.py::
test_serve_append_*``.
"""
import dataclasses
import importlib
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.core import Stage as JStage
from repro.core import by_name as jax_by_name
from repro.core import expr as jexpr
from repro.store import FieldStore as JFieldStore
from repro.stream import StreamFieldStore as JStreamFieldStore
from repro.stream import TemporalField as JTemporalField
from repro_torch import convert, serve
from repro_torch.analytics import query
from repro_torch.core import Stage, by_name, error_analysis, expr
from repro_torch.core import homomorphic as H
from repro_torch.core.stages import LEAVES
from repro_torch.serve.analytics import _region_signature
from repro_torch.store import FieldStore
from repro_torch.stream import StreamFieldStore, TemporalField

REGION = ((30, 75), (10, 52))  # unaligned window of the 181 x 97 field_2d
SPATIAL = (48, 40)             # the reference stream tests' slab extent
STREAM_REGION = ((10, 40), (5, 29))
N0, N1 = 48, 64                # the reference expression tests' crop

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


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


REF = types.SimpleNamespace(
    module=importlib.import_module("repro.serve.analytics"),
    AnalyticsFrontend=jserve.AnalyticsFrontend,
    AnalyticsRequest=jserve.AnalyticsRequest,
    AppendRequest=jserve.AppendRequest, FieldStore=JFieldStore,
    StreamFieldStore=JStreamFieldStore, expr=jexpr, Stage=JStage,
    carry=lambda c: c,
    TemporalField=lambda s, **kw: JTemporalField(jax_by_name(s), **kw))
PORT = types.SimpleNamespace(
    module=importlib.import_module("repro_torch.serve.analytics"),
    AnalyticsFrontend=serve.AnalyticsFrontend,
    AnalyticsRequest=serve.AnalyticsRequest,
    AppendRequest=serve.AppendRequest, FieldStore=FieldStore,
    StreamFieldStore=StreamFieldStore, expr=expr, Stage=Stage,
    carry=to_port,
    TemporalField=lambda s, **kw: TemporalField(s, device="cpu", **kw))


def _jc(scheme, data, rel_eb=1e-3):
    return jax_by_name(scheme).compress(jnp.asarray(data), rel_eb=rel_eb)


def _compress_many(scheme, n, shape, rel_eb=1e-3, seed=0):
    rng = np.random.default_rng(seed)
    return [_jc(scheme, rng.normal(0, 1, shape).astype(np.float32), rel_eb)
            for _ in range(n)]


def _slab(i, k=3, spatial=SPATIAL, seed=0):
    rng = np.random.default_rng(seed + 100 * i)
    t = np.arange(i * k, (i + 1) * k, dtype=np.float32)[:, None, None]
    x = (np.linspace(0, 2 * np.pi, spatial[0])[None, :, None]
         + np.linspace(0, np.pi, spatial[1])[None, None, :])
    return (np.sin(x + 0.1 * t) * 2 + 0.05 * t
            + rng.normal(0, 0.02, (k,) + spatial)).astype(np.float32)


# ===========================================================================
# running one scenario on both frontends
# ===========================================================================

class Run:
    """One scenario's run on one package: the frontend, the finished
    requests by uid (in step order), and each group query's
    ``n_dispatches``."""

    def __init__(self, ns, monkeypatch):
        self.ns = ns
        self.done: dict = {}
        self.dispatches: list = []
        self.fe = None
        mod = ns.module
        for name in ("_query_opset", "query"):
            real = getattr(mod, name)

            def spy(*a, _real=real, **kw):
                res = _real(*a, **kw)
                self.dispatches.append(res.n_dispatches)
                return res

            monkeypatch.setattr(mod, name, spy)

    def frontend(self, **kw):
        self.fe = self.ns.AnalyticsFrontend(**kw)
        return self.fe

    def drain(self) -> dict:
        fe = self.fe
        out = {}
        while fe._queue:
            for r in fe.step():
                out[r.uid] = r
        self.done.update(out)
        return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tup(x):
    return x if isinstance(x, tuple) else (x,)


def _bitwise(want, got, what):
    for w, g in zip(_tup(want), _tup(got), strict=True):
        w, g = _np(w), _np(g)
        assert (w.shape, w.dtype) == (g.shape, g.dtype), what
        assert w.tobytes() == g.tobytes(), what


def _close_value(op, want, got, what, field=None, stage=None, summary=None,
                 eps=None):
    """One result against the reference's, with the slice tolerances."""
    if op in ("mean", "std"):
        w, g = float(_np(want)), float(_np(got))
        bound = (error_analysis.mean_bias_bound if op == "mean"
                 else error_analysis.std_bias_bound)(field, Stage(int(stage)))
        e = float(field.eps.item())
        tol = max(1e-5 * abs(w), (1e-3 if bound >= e else 0.5) * bound)
        assert abs(g - w) <= tol, (what, abs(g - w), tol)
    elif op in ("divergence", "curl"):
        for w, g in zip(_tup(want), _tup(got), strict=True):
            w, g = _np(w), _np(g)
            np.testing.assert_allclose(g, w, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(w).max()),
                                       err_msg=what)
    elif op in ("tmean", "tstd"):
        tol = error_analysis.temporal_round_bound(op, summary, eps).numpy()
        diff = np.abs(_np(got).astype(np.float64) - _np(want))
        assert np.all(diff <= tol), (what, diff.max())
    elif op == "expr":
        w, g = _np(want), _np(got)
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=what)
    else:  # stencils, tdelta / tmin / tmax
        _bitwise(want, got, what)


def _same_outcomes(ref: Run, port: Run, field_of=None, temporal_of=None):
    """Both frontends answered and rejected the same uids alike, with
    values within the slice tolerances and the same dispatch counts."""
    assert sorted(ref.done) == sorted(port.done)
    assert port.dispatches == ref.dispatches
    for uid, jr in ref.done.items():
        pr = port.done[uid]
        what = f"uid {uid}"
        assert pr.done and jr.done, what
        assert (pr.error is None) == (jr.error is None), (what, pr.error,
                                                          jr.error)
        if jr.error is not None:
            assert pr.error.split(":")[0] == jr.error.split(":")[0], \
                (what, pr.error, jr.error)
            assert getattr(pr, "result", None) is None
            continue
        if hasattr(jr, "slab_index"):
            assert pr.slab_index == jr.slab_index
            continue
        if jr.exprs is not None:
            for w, g, ws, gs in zip(_tup_list(jr.result), _tup_list(pr.result),
                                    _tup_list(jr.result_stage),
                                    _tup_list(pr.result_stage), strict=True):
                assert int(ws) == int(gs), what
                _close_value("expr", w, g, what)
            continue
        names = [jr.op] if isinstance(jr.op, str) else sorted(jr.result)
        want = {jr.op: jr.result} if isinstance(jr.op, str) else jr.result
        got = {pr.op: pr.result} if isinstance(pr.op, str) else pr.result
        wst = ({jr.op: jr.result_stage} if isinstance(jr.op, str)
               else jr.result_stage)
        gst = ({pr.op: pr.result_stage} if isinstance(pr.op, str)
               else pr.result_stage)
        assert sorted(want) == sorted(got), what
        for op in names:
            assert int(wst[op]) == int(gst[op]), (what, op)
            kw = {}
            if op in ("tmean", "tstd"):
                kw = dict(zip(("summary", "eps"), temporal_of(pr)))
            elif op in ("mean", "std"):
                kw = {"field": field_of(pr), "stage": gst[op]}
            _close_value(op, want[op], got[op], f"{what} {op}", **kw)


def _tup_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _both(monkeypatch, scenario):
    """Run ``scenario(ns, run)`` on both packages; returns (ref, port)."""
    runs = []
    for ns in (REF, PORT):
        run = Run(ns, monkeypatch)
        scenario(ns, run)
        runs.append(run)
    return runs


# ===========================================================================
# tests/test_analytics.py
# ===========================================================================

def test_analytics_frontend_drains_mixed_requests(monkeypatch):
    rng = np.random.default_rng(5)
    jfields = [_jc("hszx_nd", rng.normal(0, 1, (40, 40)).astype(np.float32))
               for _ in range(5)]

    def scenario(ns, run):
        fields = [ns.carry(c) for c in jfields]
        fe = run.frontend()
        for i, c in enumerate(fields):
            fe.add_request(ns.AnalyticsRequest(uid=i, fields=c, op="mean"))
        fe.add_request(ns.AnalyticsRequest(uid=10, fields=fields[0],
                                           op="std"))
        fe.add_request(ns.AnalyticsRequest(
            uid=11, fields=(fields[0], fields[1]), op="curl"))
        run.fields = fields
        done = run.drain()
        assert len(done) == 7 and all(r.done for r in done.values())
        assert int(done[0].result_stage) == 1
        assert tuple(done[11].result.shape) == (38, 38)

    ref, port = _both(monkeypatch, scenario)
    _bitwise(H.mean(port.fields[0], Stage.M), port.done[0].result, "mean@M")
    fields = {i: port.fields[i] for i in range(5)}
    _same_outcomes(ref, port,
                   field_of=lambda r: fields.get(r.uid, port.fields[0]))


def test_analytics_frontend_isolates_bad_requests(monkeypatch):
    jc = _jc("hszp", np.linspace(0, 1, 200, dtype=np.float32))

    def scenario(ns, run):
        c = ns.carry(jc)
        run.c = c
        fe = run.frontend()
        fe.add_request(ns.AnalyticsRequest(uid=0, fields=c, op="mean"))
        fe.add_request(ns.AnalyticsRequest(uid=1, fields=c, op="derivative",
                                           stage=ns.Stage.P))
        fe.add_request(ns.AnalyticsRequest(uid=2, fields=c, op="std"))
        done = run.drain()
        assert len(done) == 3
        assert done[1].error is not None and "derivative" in done[1].error
        assert done[1].result is None
        assert done[0].error is None and done[0].result is not None
        assert done[2].error is None and done[2].result is not None

    ref, port = _both(monkeypatch, scenario)
    with pytest.raises(TypeError, match="expression form"):
        query([port.c], exprs=[expr.mean(port.c)])
    _same_outcomes(ref, port, field_of=lambda r: port.c)


# ===========================================================================
# tests/test_expr.py
# ===========================================================================

def test_serve_opset_form_deprecated(monkeypatch, field_2d):
    jc = _jc("hszp_nd", field_2d[:N0, :N1])

    def scenario(ns, run):
        c = run.c = ns.carry(jc)
        fe = run.frontend()
        fe.add_request(ns.AnalyticsRequest(uid=0, fields=c,
                                           op=["mean", "std"]))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            done = run.drain()
        assert any(issubclass(x.category, DeprecationWarning) for x in w)
        assert done[0].error is None and set(done[0].result) == {"mean",
                                                                 "std"}

    ref, port = _both(monkeypatch, scenario)
    _same_outcomes(ref, port, field_of=lambda r: port.c)


def test_serve_expression_requests(monkeypatch, field_2d):
    jc1 = _jc("hszp_nd", field_2d[:N0, :N1])
    jc2 = _jc("hszp_nd", field_2d[20:20 + N0, 6:6 + N1])

    def scenario(ns, run):
        c1, c2 = ns.carry(jc1), ns.carry(jc2)
        run.c = (c1, c2)
        fe = run.frontend()
        good = ns.AnalyticsRequest(
            uid=0, exprs=ns.expr.laplacian(c1) - ns.expr.laplacian(c2))
        multi = ns.AnalyticsRequest(
            uid=1, exprs=[ns.expr.mean(c1), ns.expr.std(c2)])
        bad = ns.AnalyticsRequest(uid=2, exprs=ns.expr.leaf(c1))
        for r in (good, multi, bad):
            fe.add_request(r)
        run.drain()
        assert bad.error is not None and "leaf" in bad.error
        assert good.error is None and multi.error is None
        assert len(multi.result) == 2 and len(multi.result_stage) == 2

    ref, port = _both(monkeypatch, scenario)
    c1, c2 = port.c
    good = port.done[0]
    st = good.result_stage
    want = (H.laplacian(c1, st) - H.laplacian(c2, st)).numpy()
    np.testing.assert_allclose(good.result.numpy(), want, rtol=1e-5,
                               atol=1e-6)
    _same_outcomes(ref, port)


# ===========================================================================
# tests/test_fused.py
# ===========================================================================

def test_serve_multi_op_request(monkeypatch, field_2d):
    jc = _jc("hszx_nd", field_2d)

    def scenario(ns, run):
        c = run.c = ns.carry(jc)
        fe = run.frontend()
        fe.add_request(ns.AnalyticsRequest(uid=0, fields=c,
                                           op=["mean", "std"]))
        fe.add_request(ns.AnalyticsRequest(uid=1, fields=c,
                                           op=["std", "mean"]))
        fe.add_request(ns.AnalyticsRequest(uid=2, fields=c, op="gradient"))
        done = run.drain()
        assert all(r.error is None for r in done.values())
        stage = done[0].result_stage["mean"]
        for uid in (0, 1):
            assert set(done[uid].result) == {"mean", "std"}
            assert done[uid].result_stage["mean"] == stage

    ref, port = _both(monkeypatch, scenario)
    c, done = port.c, port.done
    stage = done[0].result_stage["mean"]
    for uid in (0, 1):
        _bitwise(H.mean(c, stage), done[uid].result["mean"], "mean")
        _bitwise(H.std(c, stage), done[uid].result["std"], "std")
    _bitwise(H.gradient(c, done[2].result_stage), done[2].result, "gradient")
    _same_outcomes(ref, port, field_of=lambda r: c)


def test_serve_multi_op_isolates_bad_sets(monkeypatch, field_2d):
    jc = _jc("hszx_nd", field_2d)

    def scenario(ns, run):
        c = run.c = ns.carry(jc)
        fe = run.frontend()
        fe.add_request(ns.AnalyticsRequest(uid=0, fields=c,
                                           op=["mean", "std"]))
        fe.add_request(ns.AnalyticsRequest(uid=1, fields=c,
                                           op=["mean", "bogus"]))
        done = run.drain()
        assert done[0].error is None and set(done[0].result) == {"mean",
                                                                 "std"}
        assert done[1].error is not None and "bogus" in done[1].error

    ref, port = _both(monkeypatch, scenario)
    _same_outcomes(ref, port, field_of=lambda r: port.c)


# ===========================================================================
# tests/test_region.py
# ===========================================================================

def test_serve_equivalent_region_specs_group_together(field_2d):
    """slice vs (start, stop) vs numpy-int specs of the same window land in
    one batch group (the signature normalizes, not repr-compares) — the
    reference's signature too."""
    jf = _jc("hszx_nd", field_2d)
    for ns, sig in ((PORT, _region_signature),
                    (REF, REF.module._region_signature)):
        f = ns.carry(jf)
        reqs = [ns.AnalyticsRequest(uid=0, fields=f, region=REGION),
                ns.AnalyticsRequest(uid=1, fields=f,
                                    region=(slice(30, 75), slice(10, 52))),
                ns.AnalyticsRequest(uid=2, fields=f,
                                    region=((np.int64(30), np.int64(75)),
                                            (10, 52)))]
        sigs = {sig(r) for r in reqs}
        assert sigs == {REGION}
        assert sig(ns.AnalyticsRequest(uid=3, fields=f)) is None


def test_serve_region_requests(monkeypatch, field_2d):
    jfields = [_jc("hszx_nd", field_2d), _jc("hszx_nd", field_2d * 0.5)]

    def scenario(ns, run):
        fields = run.fields = [ns.carry(c) for c in jfields]
        fe = run.frontend()
        fe.add_request(ns.AnalyticsRequest(uid=0, fields=fields[0],
                                           op="mean", region=REGION))
        fe.add_request(ns.AnalyticsRequest(uid=1, fields=fields[1],
                                           op="mean", region=REGION))
        fe.add_request(ns.AnalyticsRequest(uid=2, fields=fields[0],
                                           op="mean"))
        fe.add_request(ns.AnalyticsRequest(uid=3, fields=fields[0],
                                           op="laplacian", region=REGION))
        done = run.drain()
        assert all(r.error is None for r in done.values())
        assert int(done[2].result_stage) == 1    # full field: metadata mean
        assert int(done[0].result_stage) == 2    # unaligned region: stage 2
        h, w = REGION[0][1] - REGION[0][0], REGION[1][1] - REGION[1][0]
        assert tuple(done[3].result.shape) == (h - 2, w - 2)

    ref, port = _both(monkeypatch, scenario)
    f0 = port.fields[0]
    win = by_name("hszx_nd").decompress(f0, Stage.F).numpy()[
        tuple(slice(s, e) for s, e in REGION)]
    assert abs(float(port.done[0].result) - win.mean()) <= 2e-4
    _same_outcomes(ref, port, field_of=lambda r: port.fields[r.uid == 1])


# ===========================================================================
# tests/test_store.py
# ===========================================================================

def test_serve_resolves_field_ids_one_dispatch_per_group(monkeypatch):
    jcs = _compress_many("hszx_nd", 3, (64, 48))

    def scenario(ns, run):
        cs = [ns.carry(c) for c in jcs]
        store = run.store = ns.FieldStore()
        for i, c in enumerate(cs):
            store.put(f"fields/{i}", c)
        fe = run.frontend(store=store)
        for i in range(3):
            fe.add_request(ns.AnalyticsRequest(uid=i, fields=f"fields/{i}",
                                               op=["mean", "std"]))
        done = run.drain()
        assert all(r.error is None for r in done.values())
        h0 = store.stats.hits
        fe.add_request(ns.AnalyticsRequest(uid=9, fields="fields/0",
                                           op=["mean", "std"]))
        done = run.drain()
        assert done[9].error is None and store.stats.hits > h0
        run.hits = (store.stats.hits, store.stats.misses)

    ref, port = _both(monkeypatch, scenario)
    stage = port.done[0].result_stage["mean"]
    for i in range(3):
        c = port.store.get(f"fields/{i}")
        _bitwise(H.mean(c, stage), port.done[i].result["mean"], "mean")
        _bitwise(H.std(c, stage), port.done[i].result["std"], "std")
    assert port.hits == ref.hits
    _same_outcomes(ref, port, field_of=lambda r: port.store.get(
        f"fields/{r.uid % 9}"))


def test_serve_vector_ids_and_rejections(monkeypatch, vector_field_2d):
    u, v = vector_field_2d
    ju, jv = _jc("hszp_nd", u), _jc("hszp_nd", v)

    def scenario(ns, run):
        store = run.store = ns.FieldStore()
        store.put("u", ns.carry(ju))
        store.put("v", ns.carry(jv))
        fe = run.frontend(store=store)
        fe.add_request(ns.AnalyticsRequest(uid=0, fields=("u", "v"),
                                           op="curl"))
        fe.add_request(ns.AnalyticsRequest(uid=1, fields="ghost", op="mean"))
        done = run.drain()
        assert done[0].error is None
        assert done[1].error is not None and "ghost" in done[1].error

    ref, port = _both(monkeypatch, scenario)
    got = port.done[0]
    _bitwise(H.curl([port.store.get("u"), port.store.get("v")],
                    got.result_stage), got.result, "curl")
    _same_outcomes(ref, port)


def test_serve_ids_without_store_rejected(monkeypatch):
    def scenario(ns, run):
        fe = run.frontend()                  # no store attached
        fe.add_request(ns.AnalyticsRequest(uid=0, fields="some/id",
                                           op="mean"))
        done = run.drain()
        assert done[0].error is not None and "store" in done[0].error

    ref, port = _both(monkeypatch, scenario)
    _same_outcomes(ref, port)


def test_serve_per_request_isolation_and_cache_hygiene(
        monkeypatch, field_2d, vector_field_2d):
    """Malformed requests — duplicate component ids, empty op list, region
    out of bounds — reject individually; healthy requests in the same batch
    are served, and a replay after them answers bitwise alike."""
    u, v = vector_field_2d
    ju, jv, jf = (_jc("hszp_nd", u), _jc("hszp_nd", v),
                  _jc("hszp_nd", field_2d))

    def scenario(ns, run):
        store = run.store = ns.FieldStore()
        store.put("u", ns.carry(ju))
        store.put("v", ns.carry(jv))
        store.put("f", ns.carry(jf))
        fe = run.frontend(store=store)
        fe.add_request(ns.AnalyticsRequest(uid=0, fields=("u", "u"),
                                           op="curl"))
        fe.add_request(ns.AnalyticsRequest(uid=1, fields="f", op=[]))
        fe.add_request(ns.AnalyticsRequest(uid=2, fields="f", op="mean",
                                           region=((0, 5000), (0, 10))))
        fe.add_request(ns.AnalyticsRequest(uid=3, fields=("u", "v"),
                                           op="curl"))
        fe.add_request(ns.AnalyticsRequest(uid=4, fields="f",
                                           op=["mean", "std"]))
        done = run.drain()
        assert "duplicate field ids" in done[0].error
        assert "empty op set" in done[1].error
        assert "out of bounds" in done[2].error
        assert done[3].error is None and done[4].error is None
        fe.add_request(ns.AnalyticsRequest(uid=5, fields=("u", "v"),
                                           op="curl"))
        fe.add_request(ns.AnalyticsRequest(uid=6, fields="f",
                                           op=["mean", "std"]))
        done2 = run.drain()
        assert done2[5].error is None and done2[6].error is None
        _bitwise(done2[5].result, done[3].result, "curl replay")
        for op in ("mean", "std"):
            _bitwise(done2[6].result[op], done[4].result[op], op)

    ref, port = _both(monkeypatch, scenario)
    _same_outcomes(ref, port, field_of=lambda r: port.store.get("f"))


# ===========================================================================
# tests/test_stream.py
# ===========================================================================

def test_serve_append_then_query_end_to_end(monkeypatch):
    def scenario(ns, run):
        store = ns.StreamFieldStore()
        tf = run.tf = ns.TemporalField("hszp_nd", rel_eb=1e-3)
        store.put_temporal("sim/T", tf)
        run.store = store
        fe = run.frontend(store=store)
        for i in range(3):
            fe.add_request(ns.AppendRequest(uid=i, field_id="sim/T",
                                            data=_slab(i)))
        fe.add_request(ns.AnalyticsRequest(uid=10, fields="sim/T",
                                           op=["tmean", "tdelta"]))
        fe.add_request(ns.AnalyticsRequest(uid=11, fields="sim/T",
                                           op="tstd", region=STREAM_REGION))
        done = run.drain()
        assert [done[i].slab_index for i in range(3)] == [0, 1, 2]
        assert all(done[i].error is None for i in done)

    ref, port = _both(monkeypatch, scenario)
    tf, done = port.tf, port.done
    want = tf.reference(["tmean", "tdelta"])
    _bitwise(want["tmean"], done[10].result["tmean"], "tmean")
    _bitwise(want["tdelta"], done[10].result["tdelta"], "tdelta")
    _bitwise(tf.reference(["tstd"], region=STREAM_REGION)["tstd"],
             done[11].result, "tstd")

    def temporal_of(r):
        region = STREAM_REGION if r.uid == 11 else None
        return port.store.temporal_summary("sim/T", region=region), tf.eps

    _same_outcomes(ref, port, temporal_of=temporal_of)


def test_serve_append_rejections_are_per_request(monkeypatch):
    jplain = _jc("hszx_nd", _slab(0)[0])

    def scenario(ns, run):
        store = ns.StreamFieldStore()
        store.put_temporal("s", ns.TemporalField("hszx_nd", rel_eb=1e-3))
        store.put("plain", ns.carry(jplain))
        fe = run.frontend(store=store)
        fe.add_request(ns.AppendRequest(uid=0, field_id="ghost",
                                        data=_slab(0)))
        fe.add_request(ns.AppendRequest(uid=1, field_id="plain",
                                        data=_slab(0)))
        fe.add_request(ns.AppendRequest(uid=2, field_id="s", data=_slab(0)))
        done = run.drain()
        assert "unknown field id" in done[0].error
        assert "not a temporal field" in done[1].error
        assert done[2].error is None and done[2].slab_index == 0
        fe2 = ns.AnalyticsFrontend(store=ns.FieldStore())
        fe2.add_request(ns.AppendRequest(uid=3, field_id="s", data=_slab(0)))
        (r,) = fe2.run_until_drained()
        assert r.error is not None and "streaming store" in r.error
        run.done[3] = r

    ref, port = _both(monkeypatch, scenario)
    _same_outcomes(ref, port)


# ===========================================================================
# the frontend over the port's own stores (no reference counterpart)
# ===========================================================================

def test_serve_router_over_sharded_and_local_stores(field_2d):
    """Ids in a sharded store and a local one behind one router: every
    answer equals ``query`` against single-device stores, bitwise, and one
    malformed request rejects alone."""
    from repro_torch.launch.mesh import make_analytics_mesh
    from repro_torch.shard import ShardedFieldStore

    e = to_port(jax_by_name("hszp_nd").encode(_jc("hszp_nd", field_2d)))
    sh = ShardedFieldStore(make_analytics_mesh(devices=["cpu"] * 8))
    local, single = StreamFieldStore(), StreamFieldStore()
    sh.put("big", e)
    local.put("small", e)
    single.put("big", e)
    single.put("small", e)
    fe = serve.AnalyticsFrontend(store=serve.StoreRouter(sh, local))
    specs = [("big", ["mean", "std"], Stage.Q, None),
             ("small", ["mean", "std"], Stage.Q, None),
             ("big", "gradient", Stage.P, REGION),
             ("big", "laplacian", Stage.F, None),
             ("ghost", "mean", "auto", None)]
    for uid, (fid, op, st, region) in enumerate(specs):
        fe.add_request(serve.AnalyticsRequest(uid=uid, fields=fid, op=op,
                                              stage=st, region=region))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        done = {r.uid: r for r in fe.run_until_drained()}
        assert done[4].error.startswith("KeyError: ")
        for uid, (fid, op, st, region) in enumerate(specs[:4]):
            assert done[uid].error is None
            want = query([fid], op, st, region=region, store=single)
            got = done[uid].result
            w = want.values[0]
            if isinstance(w, dict):
                for k in w:
                    _bitwise(w[k], got[k], f"{uid} {k}")
            else:
                _bitwise(w, got, str(uid))


def test_port_frontend_exports_match_reference():
    # the token Engine and Request are ported too: every export
    assert serve.__all__ == jserve.__all__ == [
        "Engine", "Request", "AnalyticsFrontend", "AnalyticsRequest",
        "AppendRequest", "StoreRouter"]
    for name in ("AnalyticsRequest", "AppendRequest", "Request"):
        assert ([f.name for f in dataclasses.fields(getattr(serve, name))]
                == [f.name for f in dataclasses.fields(getattr(jserve, name))])
