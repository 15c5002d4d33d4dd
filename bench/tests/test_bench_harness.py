"""The harness end to end on the CPU at a tiny size: one contract line."""
import json
import subprocess
import sys

import pytest

from conftest import BENCH
from spec import Spec

CELLS = [w["name"] for w in Spec().data["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", CELLS)
def test_untraced_run_prints_the_end_to_end_metrics(run_tiny, spec, workload):
    out = run_tiny(workload)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    want = {m["name"]: m["unit"] for m in spec.metrics(workload, False)}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["checks"]) >= {"rejected", "unanswered", "bad_stage"}
    assert set(line["checks"]) & {"stat_gap", "stencil_gap"}


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reads_the_per_layer_metrics(run_tiny, spec, workload):
    import torch
    # on the CPU the profiler's CPU operations stand in for device activity
    out = run_tiny(workload, seconds=1.0, trace=True)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] > 0
    got = set(out["metrics"])
    # the port counts launches of its CUDA kernels only
    want = {m["name"] for m in spec.metrics(workload, True)}
    assert got == want, (got, want)
    assert 0 < out["metrics"]["kernels_roofline"]["value"] <= 100
    names = [n for n, _ in out["breakdown"]["idle_gaps"]]
    assert "bench.step" in names
    assert len(out["breakdown"]["device_ops"]) <= 10
    del torch


def test_the_command_refuses_without_a_card():
    r = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        CELLS[0], "--seed", "3", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=BENCH.parent, timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_same_seed_same_work(spec):
    """A seed fixes the fields and the requests; seeds change only the order
    of the kinds a round deals."""
    import torch

    import synth
    a, b = (synth.make_field(2 ** 40 + 3, 5, (16, 24), "cpu") for _ in range(2))
    assert torch.equal(a, b)
    config = spec.config("ocean-hszp_nd")
    for mix in ("stats", "diff", "multi"):
        kinds = {}
        for seed in (1, 2 ** 33 + 1):
            t = spec.traffic(config, spec.mix(mix), seed)
            kinds[seed] = [r.kind for r in t.due(0.0, 0) + t.due(0.0, 50)]
        a, b = kinds.values()
        assert sorted(a) == sorted(b) and a != b


def test_closed_loop_takes_the_fields_in_turn(spec):
    config = spec.config("ocean-hszp_nd")
    t = spec.traffic(config, spec.mix("stats"), 5)
    first = t.due(0.0, 0)
    assert len(first) == t.clients and t.due(0.0, 0) == []
    assert [r.fields for r in first[:4]] == [(0,), (1,), (0,), (1,)]
    assert len(t.due(0.0, 3)) == 3
    multi = spec.traffic(config, spec.mix("multi"), 5)
    assert {r.fields for r in multi.due(0.0, 0)} == {(0, 1)}


def test_a_trace_without_device_activity_is_taken_again(run_tiny, monkeypatch):
    import tracing
    real, calls = tracing.read, []

    def first_empty(prof, device_type=None):
        calls.append(1)
        return None if len(calls) == 1 else real(prof, device_type)

    monkeypatch.setattr(tracing, "read", first_empty)
    out = run_tiny("ocean-hszp.diff", seconds=1.5, trace=True)
    assert len(calls) == 2 and out["device"]["busy_s"] > 0
    assert "kernels_roofline" in out["metrics"]
