"""The plain reference against the port at small sizes: every op kind of
the mixes, at every stage that can answer it, on both configurations."""
import pytest
import torch

from conftest import TINY_DIMS, TINY_WINDOWS

import synth
from reference import hsz
from system import System
from traffic import Request

SEED = 2 ** 35 + 7
OPS = [("mean", 0), ("std", 0), ("derivative", 0), ("derivative", 1),
       ("gradient", 0), ("laplacian", 0), ("divergence", 0), ("curl", 0)]
WINDOWS = [None] + [tuple(tuple(a) for a in w["window"]) for w in TINY_WINDOWS]
#: far under the limits, far over f32 rounding (observed at most 3e-5)
TOL = 1e-3


@pytest.fixture(scope="module", params=["ocean-hszp_nd", "ocean-hszx_nd"])
def system(request, spec):
    config = spec.config(request.param)
    config.update(dims=TINY_DIMS, block=[8, 8], timesteps=1,
                  store_bytes=1 << 20)
    return System(config, SEED, "cpu")


def _served(system, req, stage):
    r = system.submit(0, req)
    r.stage = stage
    (done,) = system.step()
    assert done.error is None, done.error
    return done.result, int(done.result_stage)


@pytest.mark.parametrize("window", WINDOWS, ids=["full", "basin", "transect"])
@pytest.mark.parametrize("op,axis", OPS)
def test_port_matches_reference(system, op, axis, window):
    cfg = system.config
    block, shape = tuple(cfg["block"]), tuple(cfg["dims"])
    fields = (0, 1) if op in ("divergence", "curl") else (1,)
    qe = [hsz.quantize(synth.make_field(SEED, i, shape, "cpu"), cfg["rel_eb"])
          for i in fields]
    stages = hsz.feasible_stages(op, cfg["scheme"], window, block, shape)
    for stage in ("auto",) + stages:
        got, at = _served(system, Request(op, fields, axis, window), stage)
        assert at in stages
        want = hsz.answer(op, qe, stage=at, window=window, axis=axis,
                          block=block)
        scale = max(float(e) for _, e in qe)
        assert hsz.gap(got, want, scale) < TOL, (op, stage, window)


def test_stage_one_mean_is_the_block_means_not_the_exact_mean(system):
    """Stage ① answers from rounded block means (paper §V-A.1): the
    reference reproduces that answer, which differs from the exact mean."""
    cfg = system.config
    if not cfg["scheme"].startswith("hszx"):
        pytest.skip("stage ① mean is the block-mean predictor's")
    block, shape = tuple(cfg["block"]), tuple(cfg["dims"])
    qe = [hsz.quantize(synth.make_field(SEED, 1, shape, "cpu"), cfg["rel_eb"])]
    got, at = _served(system, Request("mean", (1,)), 1)
    assert at == 1
    one = hsz.answer("mean", qe, stage=1, block=block)
    exact = hsz.answer("mean", qe, stage=3, block=block)
    eps = float(qe[0][1])
    assert hsz.gap(got, one, eps) < TOL
    assert hsz.gap(one, exact, eps) > 10 * TOL


def test_control_in_bfloat16_is_far_off():
    x = synth.make_field(SEED, 0, (64, 96), "cpu")
    q, eps = hsz.quantize(x, 1e-3)
    qb, eb = hsz.quantize(x, 1e-3, torch.bfloat16)
    ref = hsz.answer("gradient", [(q, eps)], stage=3)
    low = hsz.answer("gradient", [(qb, eb)], stage=3, dtype=torch.bfloat16)
    assert hsz.gap(low, ref, float(eps)) > 1.0
