"""The port's spans (``repro_torch.trace``) on the serving path.

A frontend step over a tiny store of bit-packed fields, under
``torch.profiler`` and without it: the spans nest as the layers call each
other, every name is one of :data:`trace.SPANS` and a ``cpu_op`` (not a
user annotation, which the profiler mirrors onto the device's timeline),
a step with no profiler running creates no ``RecordFunction``, and the
answers do not depend on the profiler.
"""
import re
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.core import by_name
from repro_torch.serve import AnalyticsFrontend, AnalyticsRequest
from repro_torch.store import FieldStore

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
SCHEMES = ("hszp_nd", "hszx_nd")
#: one op set a group: statistics, a stencil, a vector operator
OP_SETS = (("mean", "std"), "derivative", "curl")


def _field(i: int) -> torch.Tensor:
    y, x = np.mgrid[0:24, 0:40]
    rng = np.random.default_rng(i)
    z = np.sin(x / 5 + i) + np.cos(y / 7) + 0.01 * rng.standard_normal(x.shape)
    return torch.as_tensor(z.astype(np.float32))


def _frontend(scheme: str) -> AnalyticsFrontend:
    """Fields u, v at one packed width, behind a store that keeps no stage
    (every group decodes in its program, as the benchmark's cells do)."""
    comp = by_name(scheme, (8, 8))
    cs = [comp.compress(_field(i), rel_eb=1e-3, device="cpu") for i in (0, 1)]
    bits = max(comp.max_bits(c) for c in cs)
    store = FieldStore(cache_bytes=0)
    for fid, c in zip("uv", cs):
        store.put(fid, comp.encode(c, bits=bits))
    return AnalyticsFrontend(store=store)


def _requests(op) -> list[AnalyticsRequest]:
    op = list(op) if isinstance(op, tuple) else op
    fields = [("u", "v")] if op == "curl" else ["u", "v"]
    return [AnalyticsRequest(uid=i, fields=f, op=op)
            for i, f in enumerate(fields)]


def _step(fe: AnalyticsFrontend, requests, traced: bool):
    """One step of ``requests``: ``({uid: result}, hsz.* events or None)``."""
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
    events = (None if prof is None else
              [e for e in prof.events() if e.name.startswith("hsz.")])
    return {r.uid: r.result for r in done}, events


def _within(child, parents) -> bool:
    c = child.time_range
    return any(p is not child and p.thread == child.thread
               and p.time_range.start <= c.start and c.end <= p.time_range.end
               for p in parents)


def _nests(events, outer: str, inner: str) -> bool:
    """Every ``inner`` span lies inside an ``outer`` span, and one exists."""
    outs = [e for e in events if e.name == outer]
    ins = [e for e in events if e.name == inner]
    return bool(ins) and all(_within(e, outs) for e in ins)


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(_same, a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_step_spans_nest_as_documented(scheme):
    """One step of three groups (mean/std, derivative, curl): step >
    query > plan and engine run > op > prelude > decode; one query span a
    group; every name in ``SPANS``, each a ``cpu_op``."""
    fe = _frontend(scheme)
    requests = [r for op in OP_SETS for r in _requests(op)]
    for i, r in enumerate(requests):
        r.uid = i
    _, events = _step(fe, requests, traced=True)
    for outer, inner in (("hsz.serve.step", "hsz.serve.group_by"),
                         ("hsz.serve.step", "hsz.query"),
                         ("hsz.query", "hsz.plan"),
                         ("hsz.query", "hsz.store"),
                         ("hsz.query", "hsz.engine.run"),
                         ("hsz.engine.run", "hsz.engine.build"),
                         ("hsz.engine.run", "hsz.engine.stack"),
                         ("hsz.engine.run", "hsz.op"),
                         ("hsz.op", "hsz.prelude")):
        assert _nests(events, outer, inner), (outer, inner)
    # the decode runs inside a prelude, inside an op
    decodes = [e for e in events if e.name == "hsz.decode"]
    ops = [e for e in events if e.name == "hsz.op"]
    preludes = [e for e in events if e.name == "hsz.prelude" and _within(e, ops)]
    assert decodes and all(_within(e, preludes) for e in decodes)
    assert sum(e.name == "hsz.serve.step" for e in events) == 1
    assert sum(e.name == "hsz.query" for e in events) == len(OP_SETS)
    assert {e.name for e in events} <= set(trace.SPANS)
    assert not any(e.is_user_annotation for e in events)
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in events)


@pytest.mark.parametrize("op", OP_SETS, ids=lambda o: "-".join(o)
                         if isinstance(o, tuple) else o)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_spans_cost_no_record_function_and_change_no_answer(
        scheme, op, monkeypatch):
    """Without a profiler the step creates no ``RecordFunction``; under one
    it creates one a recorded span; the answers are the same bit for bit,
    and each op runs inside the engine, inside its group's query."""
    made = []

    def counting(name):
        made.append(name)
        return torch._C._profiler._RecordFunctionFast(name)

    monkeypatch.setattr(trace, "_FAST", counting)
    fe = _frontend(scheme)
    plain, none = _step(fe, _requests(op), traced=False)
    assert none is None and made == []
    traced, events = _step(fe, _requests(op), traced=True)
    assert sorted(made) == sorted(e.name for e in events)
    assert plain.keys() == traced.keys()
    assert all(_same(plain[k], traced[k]) for k in plain)
    for outer, inner in (("hsz.serve.step", "hsz.query"),
                         ("hsz.query", "hsz.engine.run"),
                         ("hsz.engine.run", "hsz.op")):
        assert _nests(events, outer, inner), (outer, inner)


def test_span_is_a_shared_no_op_without_a_profiler():
    assert trace.span("hsz.op") is trace.span("hsz.query")
    calls = []
    f = trace.spanned("hsz.op")(lambda *a, **k: calls.append((a, k)) or 7)
    assert f(1, b=2) == 7 and calls == [((1,), {"b": 2})]
    assert len(set(trace.SPANS)) == len(trace.SPANS)
    assert all(s.startswith("hsz.") for s in trace.SPANS)


def test_port_records_no_user_annotation():
    """``record_function`` spans are mirrored onto the device's timeline;
    the port records none."""
    call = re.compile(r"record_function\s*\(")
    hits = [str(p) for p in sorted(SRC.rglob("*.py"))
            if call.search(p.read_text())]
    assert hits == []
