"""The device's idle time by the port's spans (``program_spans.py``) and
the six metrics that read it."""
import pytest

import harness
import program_spans
from spec import Spec

CELLS = [w["name"] for w in Spec().data["workloads"]]
NEW = ("serve.idle_ms_per_step", "planner.idle_ms_per_step",
       "engine.idle_ms_per_step", "prelude.idle_ms_per_step",
       "ops.idle_ms_per_step", "serve.groups_per_step")
LAYERS = ("serve", "planner", "engine", "prelude", "ops")

#: one step in a window 0..100 us: the device busy 10..20 and 50..60
HOST = [("bench.window", 0, 100), ("bench.step", 5, 95),
        ("hsz.serve.step", 6, 90), ("hsz.serve.group_by", 6, 7),
        ("hsz.query", 8, 80), ("hsz.plan", 9, 12),
        ("hsz.engine.run", 15, 70), ("hsz.op", 30, 55),
        ("hsz.prelude", 32, 40), ("hsz.decode", 33, 36),
        ("hsz.kernel.launch", 45, 52),
        ("hsz.unclaimed", 41, 44)]         # no layer: its idle stays in ops
DEVICE = [("kernel_a", 10, 20), ("kernel_b", 50, 60)]
#: idle 0..10, 20..50, 60..100, to the innermost port span open at it
WANT = {"loop": 6 + 10,                     # 0..6, 90..100
        "serve": 1 + 1 + 1 + 10 + 10,        # 6..7, 7..8, 8..9, 70..90
        "planner": 1,                        # plan 9..10
        "engine": 10 + 10,                   # 20..30, 60..70
        "prelude": 1 + 4 + 3,                # 32..33, 36..40, decode 33..36
        "ops": 2 + 5 + 5}                    # 30..32, 40..45, launch 45..50


def _events(stand_in: bool):
    """The run's events on the card (host spans off the device, the
    benchmark's and the port's annotations mirrored onto it) or on the
    CPU stand-in (every event a "device" one)."""
    host = [(n, stand_in, s, e) for n, s, e in HOST]
    device = [(n, True, s, e) for n, s, e in DEVICE]
    if not stand_in:
        device += [("bench.step", True, 4, 96), ("hsz.op", True, 0, 100)]
    return host + device


@pytest.mark.parametrize("stand_in", [False, True], ids=["card", "cpu"])
def test_idle_goes_to_the_innermost_span_exactly(stand_in):
    got = program_spans.split(_events(stand_in))
    assert got["idle"] == 80 and got["steps"] == 1 and got["groups"] == 1
    assert {k: got[k] for k in WANT} == WANT
    assert sum(WANT.values()) == got["idle"]


def test_no_window_no_step_or_no_port_span_reads_nothing():
    events = _events(False)
    assert program_spans.split([]) is None
    assert program_spans.split([e for e in events
                                if e[0] != "bench.window"]) is None
    assert program_spans.split([e for e in events
                                if not e[0].startswith("hsz.")]) is None

    class Untraced:
        events = []
    assert program_spans.idle_ms_per_step(Untraced, "serve") is None


def test_every_port_span_has_a_layer():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))
    from repro_torch import trace
    assert {program_spans.layer_of(n) for n in trace.SPANS} == set(LAYERS)


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reports_the_span_metrics(run_tiny, workload, monkeypatch):
    real, seen = program_spans.split, []

    def keep(events):
        got = real(events)
        seen.append(got)
        return got

    monkeypatch.setattr(program_spans, "split", keep)
    out = run_tiny(workload, seconds=1.0, trace=True)
    metrics = out["metrics"]
    assert set(NEW) <= set(metrics)
    assert metrics["serve.groups_per_step"]["value"] >= 1
    assert all(metrics[m]["value"] >= 0 for m in NEW)
    got = seen[0]
    assert got["steps"] == harness.TRACE_STEPS
    layers = sum(got[k] for k in LAYERS)
    assert layers + got["loop"] == pytest.approx(got["idle"])
    assert sum(metrics[f"{k}.idle_ms_per_step"]["value"] for k in LAYERS) \
        == pytest.approx(layers * 1e-3 / got["steps"])
