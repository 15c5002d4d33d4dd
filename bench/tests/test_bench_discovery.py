"""A configuration, a traffic mix with a generator of its own and metrics
added as new files only, with new entries in BENCHMARK.json, are found by
name and run: no file of the harness is edited."""
import json
import shutil
import time

import harness
from spec import BENCH, Spec

#: an open loop: one request every ``interval_s``, timed from when it was due
OPEN_LOOP = '''
from traffic import Request


class Traffic:
    def __init__(self, config, mix, seed):
        self.interval = float(mix["interval_s"])
        self.ops = mix["ops"]
        self.next_at = None
        self.n = 0

    def due(self, now, answered):
        if self.next_at is None:
            self.next_at = now
        out = []
        while self.next_at <= now:
            op = self.ops[self.n % len(self.ops)]
            fields = (0, 1) if op in ("divergence", "curl") else (self.n % 2,)
            out.append(Request(op, fields, arrival=self.next_at))
            self.next_at += self.interval
            self.n += 1
        return out

    def kinds(self):
        return {Request(op, (0,)).kind for op in self.ops}
'''


def test_new_config_mix_generator_and_metrics_are_found_and_run(tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    data = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    before = {p.relative_to(bench) for p in bench.rglob("*") if p.is_file()}

    config = json.loads((bench / "configs" / "ocean-hszx_nd.json").read_text())
    config.update(dims=[40, 56], block=[8, 8], timesteps=3)
    (bench / "configs" / "tiny-hszx_nd.json").write_text(json.dumps(config))
    (bench / "generators" / "open_loop.py").write_text(OPEN_LOOP)
    (bench / "mixes" / "paced.json").write_text(json.dumps({
        "generator": "open_loop", "interval_s": 0.002,
        "ops": ["laplacian", "curl", "mean"]}))
    (bench / "metrics" / "window.requests.py").write_text(
        "def read(run):\n    return float(run.answered)\n")
    # a counter the harness never names, and the profile's own events
    (bench / "metrics" / "store.declined_per_request.py").write_text(
        "def read(run):\n"
        "    return run.counters['store']['rejected'] / run.answered\n")
    (bench / "metrics" / "trace.steps.py").write_text(
        "def read(run):\n"
        "    n = sum(1 for e in run.events if e[0] == 'bench.step')\n"
        "    return n or None\n")
    (bench / "limits" / "tiny-hszx.paced.json").write_text(json.dumps(
        {"rejected": 0, "unanswered": 0, "bad_stage": 0, "stat_gap": 0.01,
         "stencil_gap": 0.01}))
    data["configs"].append({"name": "tiny-hszx_nd", "source": "test",
                            "file": "bench/configs/tiny-hszx_nd.json",
                            "reduced": ["dims"], "why": "test"})
    data["workloads"].append({"name": "tiny-hszx.paced",
                              "config": "tiny-hszx_nd",
                              "traffic": "paced", "chips": 1, "why": "test"})
    cell = ["tiny-hszx.paced"]
    data["end_to_end"].append({"name": "window.requests", "unit": "req",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock", "workloads": cell})
    for name in ("store.declined_per_request", "trace.steps"):
        data["per_layer"].append({"name": name, "unit": "1",
                                  "better": "lower", "source": "program_counter",
                                  "layer": "test", "moves": "window.requests",
                                  "workloads": cell})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    after = {p.relative_to(bench) for p in bench.rglob("*") if p.is_file()}
    assert before <= after and all(
        (bench / p).read_bytes() == (BENCH / p).read_bytes() for p in before)

    spec = Spec(root=tmp_path, bench=bench)
    out = harness.run_cell(spec, "tiny-hszx.paced", 9, 0.5, False, "cpu",
                           time.perf_counter())
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"requests_per_s", "setup_s",
                                   "window.requests"}
    # about one request per interval over the window
    assert 50 < out["metrics"]["window.requests"]["value"] < 300
    assert out["checks"]["stencil_gap"]["value"] < 1e-3
    assert out["checks"]["stat_gap"]["value"] < 1e-3

    traced = harness.run_cell(spec, "tiny-hszx.paced", 10, 2.0, True, "cpu",
                              time.perf_counter())
    assert traced["correct"] is True, traced["checks"]
    got = {k: v["value"] for k, v in traced["metrics"].items()}
    assert got["store.declined_per_request"] > 0
    assert got["trace.steps"] >= harness.TRACE_STEPS
