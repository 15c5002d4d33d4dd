"""The rank-3 cell's parts on the CPU at a tiny size: the port's answers on
rank-3 fields against the 3-D reference through the harness's judge, the
bfloat16 control failing the cell's limits, and the rank-3 reference and
byte count against their rank-2 counterparts where both apply."""
import time

import pytest
import torch

import harness
import judge
import roofline
import roofline3d
import synth
from reference import hsz, hsz3d
from system import System

CELL = "miranda-hszp.multi"
#: a tiny stand-in for the Miranda fields (no axis a multiple of the block)
TINY3 = [20, 27, 29]
SEED = 2 ** 36 + 5


@pytest.fixture(scope="module")
def tiny3(spec):
    cell = spec.workload(CELL)
    config = spec.config(cell["config"])
    config.update(dims=TINY3)
    mix = dict(spec.mix(cell["traffic"]), clients=6)
    return config, mix


def test_port_and_3d_reference_agree_through_the_judge(spec, tiny3):
    config, mix = tiny3
    system = System(config, SEED, "cpu")
    traffic = spec.traffic(config, mix, SEED)
    requests = traffic.due(0.0, 0)
    for uid, r in enumerate(requests):
        system.submit(uid, r)
    done = system.step()
    sampled = [(requests[d.uid], d.result, int(d.result_stage)) for d in done]
    assert {r.op for r, _, _ in sampled} == {"curl", "divergence"}
    assert all(len(v) == 3 for r, v, _ in sampled if r.op == "curl")
    _, stencil_gap, bad = judge.compare(config, SEED, "cpu", sampled)
    limit = spec.limits(CELL)["stencil_gap"]
    assert bad == 0 and stencil_gap < 1e-3 < limit
    _, control_gap, _ = judge.compare(config, SEED, "cpu", sampled,
                                      control=True)
    assert control_gap > limit


def test_the_cell_runs_at_rank_3(spec, tiny3):
    config, mix = tiny3
    out = harness.run_cell(spec, CELL, SEED, 0.5, True, "cpu",
                           time.perf_counter(), config=config, mix=mix,
                           control=True)
    assert out["correct"] is True, out["checks"]
    assert [k for k, c in out["control"].items() if c["value"] > c["limit"]]
    metrics = {k: v["value"] for k, v in out["metrics"].items()}
    # three derivatives a divergence group, six a curl group, two groups
    assert metrics["ops.torch_rules_per_step"] == pytest.approx(9.0)
    assert 0 < metrics["kernels_roofline"] <= 100


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_the_3d_curl_agrees_with_the_nd_rules_where_both_answer(dtype):
    """Each derivative is the n-D reference's; the curl's third component
    is the n-D reference's (2-D) curl of (u, v)."""
    qe = [hsz.quantize(synth.make_field(SEED, i, tuple(TINY3), "cpu"), 1e-3,
                       dtype if dtype == torch.bfloat16 else torch.float32)
          for i in range(3)]
    for axis in range(3):
        got = hsz3d.derivative(*qe[axis], axis, dtype)
        want = hsz.answer("derivative", qe[axis:axis + 1], stage=2, axis=axis,
                          dtype=dtype)
        assert torch.equal(got, want)
    got = hsz3d.curl(qe, dtype)
    assert len(got) == 3 and all(c.shape == got[0].shape for c in got)
    assert torch.equal(got[2], hsz.answer("curl", qe[:2], stage=2, dtype=dtype))


OCEAN = (2400, 3600)
BASIN = ((600, 1801), (900, 2703))


@pytest.mark.parametrize("window", [None, BASIN], ids=["full", "basin"])
@pytest.mark.parametrize("op,axis", [("mean", 0), ("std", 0), ("derivative", 0),
                                     ("derivative", 1), ("gradient", 0),
                                     ("laplacian", 0), ("divergence", 0),
                                     ("curl", 0)])
def test_the_box_count_is_the_rank2_count_on_rank2_fields(op, axis, window):
    bits = (9, 7) if op in ("divergence", "curl") else (9,)
    want = roofline.least_bytes("hszp_nd", op, OCEAN, bits=bits, block=(16, 16),
                                window=window, axis=axis)
    got = roofline3d.least_bytes("hszp_nd", op, OCEAN, bits=bits,
                                 window=window, axis=axis)
    assert got == want
