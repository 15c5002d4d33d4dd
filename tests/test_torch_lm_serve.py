"""The port's token-serving engine (``repro_torch.serve.Engine``) and its
launcher against the JAX reference.

The engine keeps the reference's slot semantics (one position counter
shared by all slots, prompts fed through single-slot steps), so on the same
params and requests both engines emit the same greedy tokens: checked at
f32 compute (``compute_dtype=float32``), where logits agree to about 2e-6
(``test_torch_models.py``), with ``kv_quant`` off and on.  Caches after a
run are compared with ``rtol=1e-4``, ``atol=1e-4`` (int8 caches: equal).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_model as jget_model
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro_torch import configs, convert
from repro_torch.models import get_model
from repro_torch.models.common import tree_map
from repro_torch.serve import Engine, Request

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)


def _port_model(name="smollm-360m", **kw):
    cfg = dataclasses.replace(configs.reduced(configs.ARCHS[name]), **kw)
    m = get_model(cfg)
    params, _ = m.init(torch.Generator().manual_seed(0), device="cpu")
    return cfg, m, params


def _pair(name, **kw):
    jc = dataclasses.replace(jconfigs.reduced(jconfigs.ARCHS[name]),
                             compute_dtype=jnp.float32, **kw)
    tc = dataclasses.replace(configs.reduced(configs.ARCHS[name]),
                             compute_dtype=torch.float32, **kw)
    jm = jget_model(jc)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tp = convert.params_from_arrays(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, get_model(tc), tp


def _requests(cls, vocab, n, prompt_len, new, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(1, vocab, prompt_len).astype(np.int32),
                max_new_tokens=new) for i in range(n)]


def _drain(eng, reqs):
    for r in reqs:
        eng.add_request(r)
    return {r.uid: r.out_tokens for r in eng.run_until_drained()}


def _same_cache(jcache, tcache):
    def leaf(t, a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            np.testing.assert_array_equal(t.numpy(), a)
        else:
            np.testing.assert_allclose(t.numpy(), a, **TOL)
    tree_map(leaf, tcache, jcache)


# ===========================================================================
# the reference's engine tests, on the port
# ===========================================================================

def test_engine_drains_requests():
    cfg, m, params = _port_model()
    eng = Engine(m, params, slots=2, max_len=64, device="cpu")
    done = _drain(eng, _requests(Request, cfg.vocab, 5, 5, 4))
    assert sorted(done) == list(range(5))
    for toks in done.values():
        assert len(toks) == 4 and all(0 <= t < cfg.vocab for t in toks)
    assert all(r is None for r in eng.active) and not eng._queue


def test_engine_greedy_matches_manual_decode():
    """Single request: engine output == manual greedy decode loop."""
    cfg, m, params = _port_model()
    prompt = np.asarray([5, 17, 3], np.int32)
    eng = Engine(m, params, slots=1, max_len=32, device="cpu")
    out = _drain(eng, [Request(uid=0, prompt=prompt, max_new_tokens=5)])[0]
    cache = m.init_cache(1, 32, device="cpu")
    for t in prompt:
        logits, cache = m.decode_step(params, torch.tensor([[t]], dtype=torch.int32),
                                      cache)
    manual = []
    for _ in range(5):
        nxt = int(torch.argmax(logits[0, -1]))
        manual.append(nxt)
        logits, cache = m.decode_step(params, torch.tensor([[nxt]], dtype=torch.int32),
                                      cache)
    assert out == manual


def test_engine_eos_stops_a_request():
    cfg, m, params = _port_model()
    prompt = np.asarray([5, 17, 3], np.int32)
    first = _drain(Engine(m, params, slots=1, max_len=32, device="cpu"),
                   [Request(uid=0, prompt=prompt, max_new_tokens=5)])[0]
    eng = Engine(m, params, slots=1, max_len=32, eos_id=first[1], device="cpu")
    assert _drain(eng, [Request(uid=0, prompt=prompt, max_new_tokens=5)])[0] == \
        first[:first.index(first[1]) + 1]


# ===========================================================================
# against the reference's Engine
# ===========================================================================

CASES = [(a, q) for a in ("smollm-360m", "granite-moe-3b-a800m")
         for q in (False, True)]


@pytest.mark.parametrize("name,kv_quant", CASES,
                         ids=[f"{a}-{'int8' if q else 'f32'}" for a, q in CASES])
def test_engine_tokens_match_reference(name, kv_quant):
    jm, jp, tm, tp = _pair(name, kv_quant=kv_quant)
    vocab = tm.cfg.vocab
    jeng = JEngine(jm, jp, slots=3, max_len=48)
    teng = Engine(tm, tp, slots=3, max_len=48, device="cpu")
    want = _drain(jeng, _requests(JRequest, vocab, 5, 6, 5))
    got = _drain(teng, _requests(Request, vocab, 5, 6, 5))
    assert got == want
    assert int(teng.cache["pos"]) == int(jeng.cache["pos"])
    _same_cache(jeng.cache, teng.cache)


def test_position_past_max_len_writes_where_the_reference_writes():
    """The shared position counter passes ``max_len`` on a long run: the
    reference's cache write clamps to the last row, and so does the port's
    (where torch indexing would raise)."""
    jm, jp, tm, tp = _pair("smollm-360m")
    max_len = 8
    jeng = JEngine(jm, jp, slots=2, max_len=max_len)
    teng = Engine(tm, tp, slots=2, max_len=max_len, device="cpu")
    want = _drain(jeng, _requests(JRequest, tm.cfg.vocab, 3, 4, 6))
    got = _drain(teng, _requests(Request, tm.cfg.vocab, 3, 4, 6))
    assert int(teng.cache["pos"]) == int(jeng.cache["pos"]) > max_len
    assert got == want
    _same_cache(jeng.cache, teng.cache)


# ===========================================================================
# the launcher, the devices, the imports
# ===========================================================================

def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300, **kw)


def test_launch_serve_cli_on_cpu():
    res = _run(["-m", "repro_torch.launch.serve", "--reduced", "--device", "cpu"])
    assert res.returncode == 0, res.stderr
    assert "[serve] 8 requests, 128 tokens" in res.stdout
    assert "device=cpu" in res.stdout


def test_entry_points_default_to_the_card():
    """Without a card the default ``device="cuda"`` raises; nothing moves
    to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg, m, params = _port_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(m, params, slots=1, max_len=8)
    from repro_torch.data import ScientificStore
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScientificStore()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init(torch.Generator().manual_seed(0))


def test_port_imports_without_jax():
    mods = ["repro_torch.configs", "repro_torch.models", "repro_torch.serve",
            "repro_torch.data", "repro_torch.launch", "repro_torch.launch.serve",
            "repro_torch.convert", "repro_torch.examples.quickstart",
            "repro_torch.examples.derived_operators",
            "repro_torch.examples.homomorphic_analytics",
            "repro_torch.examples.serve_batched"]
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
            "import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from repro_torch.serve import Engine, Request\n"
            "from repro_torch.data import ScientificStore\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.')) "
            "for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')")
    res = _run(["-c", code])
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.mark.gpu
def test_engine_on_the_card_matches_the_cpu_port():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, m, params = _port_model(compute_dtype=torch.float32)
    cuda_params = tree_map(lambda t: t.to("cuda"), params)
    want = _drain(Engine(m, params, slots=3, max_len=48, device="cpu"),
                  _requests(Request, cfg.vocab, 5, 6, 5))
    got = _drain(Engine(m, cuda_params, slots=3, max_len=48, device="cuda"),
                 _requests(Request, cfg.vocab, 5, 6, 5))
    assert got == want
