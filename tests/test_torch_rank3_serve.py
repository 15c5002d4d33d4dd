"""Rank-3 fields served through the port's normal path, against the plain
reference of the benchmark's rank-3 cell: ``bench/reference/hsz3d.py`` for
the 3-D curl, ``bench/reference/hsz.py`` for every other op.

Bit-packed HSZp-nd fields at 24 × 40 × 32 and at a padded 21 × 37 × 30 (8³
blocks) in a ``FieldStore`` behind ``AnalyticsFrontend.step``, at stage
auto and at ② ③ ④: divergence and the 3-D curl of three components, the
derivative along each axis, the Laplacian, mean and std.  A group of
requests answers as its requests do alone, bit for bit; the same requests
served by the reference package's ``AnalyticsFrontend`` on the same
containers answer alike; under the profiler every torch rule that stands
in for a declined fused rule runs under one ``hsz.op.torch`` span.  The benchmark's rank-3 byte count
(``bench/roofline3d.py``) and the generator of its rank-3 cell
(``bench/generators/closed_loop_vector.py``) are checked here too.
"""
import importlib.util
import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro import serve as jserve
from repro.core import by_name as jax_by_name
from repro.kernels import ops as jops
from repro.store import FieldStore as JFieldStore
from torch.profiler import ProfilerActivity, profile

from repro_torch import convert
from repro_torch.core import Stage, by_name, error_analysis
from repro_torch.core.stages import LEAVES
from repro_torch.kernels import ops as kernel_ops
from repro_torch.serve import AnalyticsFrontend, AnalyticsRequest
from repro_torch.store import FieldStore

BENCH = Path(__file__).resolve().parents[1] / "bench"
SHAPES = ((24, 40, 32), (21, 37, 30))
BLOCK = (8, 8, 8)
REL_EB = 1e-3
IDS = ("u", "v", "w", "p")
VECTOR = ("u", "v", "w")
#: op, axis, fields of every request kind served
KINDS = (("divergence", 0, VECTOR), ("curl", 0, VECTOR),
         ("derivative", 0, "p"), ("derivative", 1, "p"),
         ("derivative", 2, "p"), ("laplacian", 0, "p"),
         ("mean", 0, "p"), ("std", 0, "p"))
#: widest gap in units of eps.  A stencil answer is one f32 product of an
#: exact integer difference (|d| < 2^12 quanta here) and eps, a curl or a
#: divergence adds f32 sums of such terms: a few units of 2^-24 |d|, under
#: 1e-3.  A statistic is an f32 reduction over ~3e4 integers of |q| < 2^11
#: (mean) or their squares (std): 1e-2 covers its rounding.  The bfloat16
#: control (8 bits of mantissa) is off by whole quanta and fails both.
TOL = {"stencil": 1e-3, "stat": 1e-2}


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


hsz = _load("bench_reference_hsz", BENCH / "reference" / "hsz.py")
hsz3d = _load("bench_reference_hsz3d", BENCH / "reference" / "hsz3d.py")


def _raw(shape, i: int) -> torch.Tensor:
    """A smooth seeded field with noise, as the benchmark's fields are."""
    g = torch.Generator().manual_seed(1000 + i)
    out = torch.randn(shape, generator=g) * 0.02
    for axis, n in enumerate(shape):
        phase = float(torch.rand((), generator=g)) * 6.0
        wave = torch.sin(torch.linspace(0, 3 + i, n) + phase)
        out += wave.reshape([n if a == axis else 1 for a in range(len(shape))])
    return out


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(map(str, s)))
def fields(request):
    """``(raw fields by id, bit-packed Encoded fields by id)``."""
    comp = by_name("hszp_nd", BLOCK)
    raw = {fid: _raw(request.param, i) for i, fid in enumerate(IDS)}
    cs = {fid: comp.compress(x, rel_eb=REL_EB, device="cpu")
          for fid, x in raw.items()}
    bits = max(comp.max_bits(c) for c in cs.values())
    return raw, {fid: comp.encode(c, bits=bits) for fid, c in cs.items()}


def _frontend(encoded) -> AnalyticsFrontend:
    store = FieldStore(cache_bytes=0)
    for fid, e in encoded.items():
        store.put(fid, e)
    return AnalyticsFrontend(store=store)


def _step(fe, requests, traced=False, span="hsz.op.torch"):
    """One step of ``requests``: ``({uid: request}, spans named ``span``)``."""
    for r in requests:
        fe.add_request(r)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        if traced:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                done = fe.step()
        else:
            done, prof = fe.step(), None
    assert all(r.error is None for r in done), [r.error for r in done]
    spans = (None if prof is None else
             sum(e.name == span for e in prof.events()))
    return {r.uid: r for r in done}, spans


def _request(uid, kind, stage="auto"):
    op, axis, ids = kind
    return AnalyticsRequest(uid=uid, fields=ids, op=op, axis=axis, stage=stage)


def _gap(got, want, eps) -> float:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    worst = 0.0
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        worst = max(worst, (g.double() - w.double()).abs().max().item() / eps)
    return worst


def _reference(raw, kind, stage=2, dtype=torch.float64):
    """``(answer, eps)``: the cell's reference answer (the bfloat16 control
    with ``dtype=torch.bfloat16``) and the widest of the fields' eps."""
    op, axis, ids = kind
    ids = ids if isinstance(ids, tuple) else (ids,)
    qe = [hsz.quantize(raw[i], REL_EB, torch.float32 if dtype == torch.float64
                       else dtype) for i in ids]
    if op == "curl":
        want = hsz3d.curl(qe, dtype)
    else:
        want = hsz.answer(op, qe, stage=stage, axis=axis, block=BLOCK,
                          dtype=dtype)
    return want, max(float(e) for _, e in qe)


@pytest.mark.parametrize("stage", ["auto", 2, 3, 4])
def test_every_kind_matches_the_rank3_reference(fields, stage):
    raw, encoded = fields
    got, _ = _step(_frontend(encoded),
                   [_request(i, k, stage) for i, k in enumerate(KINDS)])
    for i, kind in enumerate(KINDS):
        r = got[i]
        assert int(r.result_stage) == (2 if stage == "auto" else stage)
        want, eps = _reference(raw, kind, int(r.result_stage))
        cat = "stat" if kind[0] in ("mean", "std") else "stencil"
        assert _gap(r.result, want, eps) < TOL[cat], (kind, stage)


def test_the_bfloat16_control_fails_the_tolerance(fields):
    raw, _ = fields
    worst = {"stencil": 0.0, "stat": 0.0}
    for kind in KINDS:
        want, eps = _reference(raw, kind)
        low, _ = _reference(raw, kind, dtype=torch.bfloat16)
        cat = "stat" if kind[0] in ("mean", "std") else "stencil"
        worst[cat] = max(worst[cat], _gap(low, want, eps))
    assert all(worst[c] > TOL[c] for c in TOL), worst


def test_a_group_answers_as_its_requests_alone(fields):
    _, encoded = fields
    triples = (("u", "v", "w"), ("v", "w", "p"), ("p", "u", "v"))
    kinds = [(op, 0, t) for op in ("curl", "divergence") for t in triples]
    kinds += [("derivative", 2, fid) for fid in IDS]
    together, _ = _step(_frontend(encoded),
                        [_request(i, k) for i, k in enumerate(kinds)])
    for i, kind in enumerate(kinds):
        alone, _ = _step(_frontend(encoded), [_request(i, kind)])
        a, b = together[i].result, alone[i].result
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        assert len(a) == len(b) and all(map(torch.equal, a, b)), kind


def _to_port(jc):
    """The reference package's container ``jc`` as the port's, on the CPU."""
    kind = type(jc).__name__
    arrays = {n: np.asarray(getattr(jc, n)) for n in LEAVES[kind]}
    meta = {"scheme": jc.scheme.value, "shape": jc.shape,
            "padded_shape": jc.padded_shape, "block": jc.block,
            "orig_dtype": np.dtype(jc.orig_dtype).name, "bits": jc.bits}
    return convert.from_arrays(kind, arrays, meta, device="cpu")


@pytest.fixture(scope="module")
def twins():
    """The padded 21 x 37 x 30 fields compressed and packed by the reference
    package, and the same containers as the port's."""
    comp = jax_by_name("hszp_nd", BLOCK)
    cs = {fid: comp.compress(jnp.asarray(_raw(SHAPES[1], i).numpy()),
                             rel_eb=REL_EB) for i, fid in enumerate(IDS)}
    bits = max(comp.max_bits(c) for c in cs.values())
    js = {fid: comp.encode(c, bits=bits) for fid, c in cs.items()}
    return js, {fid: _to_port(e) for fid, e in js.items()}


@pytest.mark.parametrize("stage", ["auto", 3])
def test_the_reference_frontend_answers_alike(twins, stage):
    """The reference package's frontend, its kernels off (the port's
    rank-3 rules are torch rules too), on the same containers.  Stencils
    are exact integer differences times eps: bit for bit.  Divergence and
    curl add f32 terms in an order each package picks: 1e-6 of the largest
    value.  Mean and std are f32 reductions of a different order: within
    the port's own bias bound (``error_analysis``), as the 2-D slices."""
    js, ts = twins
    store = JFieldStore(cache_bytes=0)
    for fid, e in js.items():
        store.put(fid, e)
    jfe = jserve.AnalyticsFrontend(store=store)
    for i, (op, axis, ids) in enumerate(KINDS):
        jfe.add_request(jserve.AnalyticsRequest(uid=i, fields=ids, op=op,
                                                axis=axis, stage=stage))
    with jops.override_mode("off"), warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = {r.uid: r for r in jfe.step()}
    got, _ = _step(_frontend(ts),
                   [_request(i, k, stage) for i, k in enumerate(KINDS)])
    for i, (op, _, ids) in enumerate(KINDS):
        w, g = want[i], got[i]
        assert w.error is None, w.error
        assert int(w.result_stage) == int(g.result_stage), op
        if op in ("mean", "std"):
            field = ts[ids]
            bound = (error_analysis.mean_bias_bound if op == "mean"
                     else error_analysis.std_bias_bound)(
                         field, Stage(int(g.result_stage)))
            ww, gg = float(np.asarray(w.result)), float(g.result)
            tol = max(1e-5 * abs(ww), (1e-3 if bound >= float(field.eps)
                                       else 0.5) * bound)
            assert abs(gg - ww) <= tol, (op, abs(gg - ww), tol)
            continue
        wt = w.result if isinstance(w.result, tuple) else (w.result,)
        gt = g.result if isinstance(g.result, tuple) else (g.result,)
        assert len(wt) == len(gt), op
        for a, b in zip(wt, gt):
            a, b = np.asarray(a), b.numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, op
            if op in ("divergence", "curl"):
                np.testing.assert_allclose(b, a, rtol=1e-6,
                                           atol=1e-6 * float(np.abs(a).max()),
                                           err_msg=op)
            else:
                assert a.tobytes() == b.tobytes(), (op, axis)


@pytest.mark.parametrize("scheme", ["hszx_nd", "hszp_nd"])
def test_each_declined_torch_rule_runs_under_one_span(fields, scheme):
    """Divergence takes three derivatives, the 3-D curl six, a derivative
    one: on a block-mean (HSZx) field each a torch rule where the fused
    derivative declines rank 3; on a Lorenzo (HSZp) field the rank-3 rule
    takes them all, so none runs under the span.  Mean and std have no
    fused rule to decline."""
    raw, encoded = fields
    if scheme == "hszx_nd":
        comp = by_name(scheme, BLOCK)
        cs = {fid: comp.compress(x, rel_eb=REL_EB, device="cpu")
              for fid, x in raw.items()}
        bits = max(comp.max_bits(c) for c in cs.values())
        encoded = {fid: comp.encode(c, bits=bits) for fid, c in cs.items()}
    per = 1 if scheme == "hszx_nd" else 0
    want = {"divergence": 3 * per, "curl": 6 * per, "derivative": per,
            "mean": 0, "std": 0}
    for op, n in want.items():
        ids = VECTOR if op in ("divergence", "curl") else "p"
        _, spans = _step(_frontend(encoded), [_request(0, (op, 2, ids))],
                         traced=True)
        assert spans == n, op
    assert kernel_ops.kernels_enabled()
    with kernel_ops.override_mode("off"):    # no fused rule asked: no span
        _, spans = _step(_frontend(encoded),
                         [_request(0, ("curl", 0, VECTOR))], traced=True)
    assert spans == 0


def test_no_span_on_a_covered_rank2_field():
    comp = by_name("hszp_nd", (8, 8))
    cs = [comp.compress(_raw((24, 40), i), rel_eb=REL_EB, device="cpu")
          for i in range(2)]
    bits = max(comp.max_bits(c) for c in cs)
    fe = _frontend({fid: comp.encode(c, bits=bits) for fid, c in zip("uv", cs)})
    assert kernel_ops.kernels_enabled()
    requests = [_request(0, ("curl", 0, ("u", "v"))),
                _request(1, ("derivative", 1, "u")),
                _request(2, ("laplacian", 0, "v"))]
    _, spans = _step(fe, requests, traced=True)
    assert spans == 0


@pytest.fixture
def bench_modules(monkeypatch):
    """The benchmark's own modules, importable for one test."""
    before = set(sys.modules)
    monkeypatch.syspath_prepend(str(BENCH))
    yield
    for name in set(sys.modules) - before:
        if str(getattr(sys.modules[name], "__file__", "")).startswith(str(BENCH)):
            del sys.modules[name]


def test_least_bytes_by_hand_on_a_4x4x4_field(bench_modules):
    import roofline3d
    shape, bits = (4, 4, 4), 8      # one byte a residual
    # axis-0 difference: the box [1, 4) x [0, 3) x [0, 3): 27 residuals;
    # one anchor; the interior 2 x 2 x 2 answers at 4 bytes
    assert roofline3d.least_bytes("hszp_nd", "derivative", shape, bits=bits,
                                  axis=0) == 27 + 4 + 32
    # divergence: one such box per component, one anchor each
    assert roofline3d.least_bytes("hszp_nd", "divergence", shape,
                                  bits=(8, 8, 8)) == 3 * (27 + 4) + 32
    # curl: u along axes 1 and 2, [0, 3) x [1, 4) x [0, 3) and [0, 3) x
    # [0, 3) x [1, 4), meeting in [0, 3) x [1, 3) x [1, 3): 27 + 27 - 12 =
    # 42 residuals; v, w alike; three components of answers
    assert roofline3d.least_bytes("hszp_nd", "curl", shape,
                                  bits=(8, 8, 8)) == 3 * (42 + 4) + 3 * 32
    # a statistic: the whole prefix box, one answer
    assert roofline3d.least_bytes("hszp_nd", "mean", shape, bits=bits) \
        == 64 + 4 + 4


def test_the_generator_deals_the_velocity_field(bench_modules):
    import json
    gen = _load("bench_generator_closed_loop_vector",
                BENCH / "generators" / "closed_loop_vector.py")
    config = json.loads((BENCH / "configs" / "miranda-hszp_nd.json").read_text())
    mix = json.loads((BENCH / "mixes" / "multi3d.json").read_text())
    traffic = gen.Traffic(config, mix, 2 ** 40 + 1)
    requests = traffic.due(0.0, 0) + traffic.due(0.0, 64)
    names = config["components"]
    assert len(requests) == 96
    assert {r.op for r in requests} == {"divergence", "curl"}
    assert {tuple(names[i] for i in r.fields) for r in requests} \
        == {("velocityx", "velocityy", "velocityz")}
