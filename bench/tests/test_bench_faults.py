"""The output check fails what it must: the control (the reference in
bfloat16 in the system's place) and faults planted under the timed path.
One chip runs no exchange between chips, so that fault has no place here."""
import time

import pytest
import torch

import harness
import system as system_mod
from spec import Spec

CELLS = [w["name"] for w in Spec().data["workloads"]]


def _failed(checks: dict) -> list[str]:
    return [k for k, c in checks.items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_limits(run_tiny, workload):
    out = run_tiny(workload, control=True)
    assert out["correct"] is True, out["checks"]
    assert _failed(out["control"])


def _altered(step):
    """Each answer altered where it is produced: one value moved by one
    quantum."""
    def run(self):
        done = step(self)
        for r in done:
            if r.result is None:
                continue
            first = r.result[0] if isinstance(r.result, tuple) else r.result
            eps = float(self.store.get("f0").eps)
            first.view(-1)[first.numel() // 2] += eps
        return done
    return run


def _half_left_out(step):
    """Half of each step's answers of a kind left out, each replaced by the
    mean of the other half's."""
    def run(self):
        done = step(self)
        kinds: dict = {}
        for r in done:
            if r.result is not None and not isinstance(r.result, tuple):
                kinds.setdefault((r.op, r.axis, str(r.region)), []).append(r)
        for rs in kinds.values():
            keep, drop = rs[:len(rs) - len(rs) // 2], rs[len(rs) - len(rs) // 2:]
            mean = torch.stack([r.result for r in keep]).mean(0)
            for r in drop:
                r.result = mean.clone()
        return done
    return run


def _unchanged(step):
    """A step that returns its state unchanged: nothing served."""
    return lambda self: []


def _faults():
    """Each cell with each fault it can have: a cell whose requests of a
    kind are all one request (a vector operator over the one (u, v) pair)
    gives the same answer with half its batch left out."""
    for w in CELLS:
        single = Spec().mix(Spec().workload(w)["traffic"])
        vector_only = all(e["op"] in ("divergence", "curl")
                          for e in single["deck"])
        for fault, name in ((_altered, "answer-altered"),
                            (_half_left_out, "half-left-out"),
                            (_unchanged, "unchanged")):
            if not (vector_only and fault is _half_left_out):
                yield pytest.param(w, fault, id=f"{w}-{name}")


@pytest.mark.parametrize("workload,fault", list(_faults()))
def test_a_fault_under_the_timed_path_is_not_correct(run_tiny, monkeypatch,
                                                     workload, fault):
    monkeypatch.setattr(system_mod.System, "step",
                        fault(system_mod.System.step))
    # every kind of the deck more than once in a step, so half can be left
    # out; a window of some tens of steps even on a loaded CPU
    out = run_tiny(workload, seconds=1.5, drain_s=0.3, clients=24)
    assert out["correct"] is False
    assert _failed(out["checks"])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_size_on_the_card(spec, workload):
    device = _card()
    out = harness.run_cell(spec, workload, 2 ** 32 + 15, 2.0, False, device,
                           time.perf_counter(), control=True)
    assert out["correct"] is True, out["checks"]
    assert _failed(out["control"])


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [p.values[0] for p in _faults()
                                      if p.values[1] is _half_left_out])
def test_half_left_out_fails_at_the_cells_size_on_the_card(spec, monkeypatch,
                                                          workload):
    device = _card()
    monkeypatch.setattr(system_mod.System, "step",
                        _half_left_out(system_mod.System.step))
    out = harness.run_cell(spec, workload, 2 ** 32 + 17, 2.0, False, device,
                           time.perf_counter())
    assert out["correct"] is False
    assert _failed(out["checks"])
