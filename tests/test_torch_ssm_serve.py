"""The port's token-serving engine on the ssm, hybrid and audio families,
against the JAX reference's engine, and the launcher for each arch.

The engine is family-agnostic: on the same params and requests both
engines emit the same greedy tokens at f32 compute (``compute_dtype=float32``),
where logits agree to about 3e-6 (``test_torch_ssm_models.py``).  Caches
after a run are compared with ``rtol=1e-4``, ``atol=1e-4`` (int8 caches:
equal).  Whisper is served as the reference serves it: the engine never
fills the cross cache, so its tokens attend to zero cross K/V in both
packages; ``kv_quant`` is checked off and on.
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
ARCHS = ["falcon-mamba-7b", "recurrentgemma-9b", "whisper-base"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _port_model(name, **kw):
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


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 else np.asarray(x)


def _same_cache(jcache, tcache):
    def leaf(t, a):
        assert tuple(t.shape) == tuple(a.shape)
        assert str(t.dtype).removeprefix("torch.") == str(a.dtype)
        if t.dtype == torch.int8:
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))
        else:
            np.testing.assert_allclose(_np(t), _np(a), **TOL)
    tree_map(leaf, tcache, jcache)


# ===========================================================================
# the reference's engine tests, on the port
# ===========================================================================

@pytest.mark.parametrize("name", ARCHS)
def test_engine_drains_requests(name):
    cfg, m, params = _port_model(name)
    eng = Engine(m, params, slots=2, max_len=64, device="cpu")
    done = _drain(eng, _requests(Request, cfg.vocab, 5, 5, 4))
    assert sorted(done) == list(range(5))
    for toks in done.values():
        assert len(toks) == 4 and all(0 <= t < cfg.vocab for t in toks)
    assert all(r is None for r in eng.active) and not eng._queue


@pytest.mark.parametrize("name", ARCHS)
def test_engine_greedy_matches_manual_decode(name):
    """Single request: engine output == manual greedy decode loop."""
    cfg, m, params = _port_model(name)
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


# ===========================================================================
# against the reference's Engine
# ===========================================================================

CASES = [("falcon-mamba-7b", False), ("recurrentgemma-9b", False),
         ("whisper-base", False), ("whisper-base", True)]


@pytest.mark.parametrize("name,kv_quant", CASES,
                         ids=[f"{a}-{'int8' if q else 'f32'}" for a, q in CASES])
def test_engine_tokens_match_reference(name, kv_quant):
    """Same greedy tokens and the same cache after the run.  The
    recurrentgemma run passes its window of 16 (the shared position counter
    reaches 34), so its ring buffer wraps."""
    jm, jp, tm, tp = _pair(name, kv_quant=kv_quant)
    vocab = tm.cfg.vocab
    jeng = JEngine(jm, jp, slots=3, max_len=48)
    teng = Engine(tm, tp, slots=3, max_len=48, device="cpu")
    want = _drain(jeng, _requests(JRequest, vocab, 5, 6, 5))
    got = _drain(teng, _requests(Request, vocab, 5, 6, 5))
    assert got == want
    assert int(teng.cache["pos"]) == int(jeng.cache["pos"])
    if name == "recurrentgemma-9b":
        assert int(teng.cache["pos"]) > tm.cfg.window
    _same_cache(jeng.cache, teng.cache)
    if name == "whisper-base":      # the engine never fills the cross cache
        assert not teng.cache["layers"]["cross"]["k"].any()


# ===========================================================================
# the launcher, the imports
# ===========================================================================

def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300, **kw)


@pytest.mark.parametrize("name", ARCHS)
def test_launch_serve_cli_on_cpu(name):
    res = _run(["-m", "repro_torch.launch.serve", "--arch", name, "--reduced",
                "--device", "cpu"])
    assert res.returncode == 0, res.stderr
    assert "[serve] 8 requests, 128 tokens" in res.stdout
    assert "device=cpu" in res.stdout


def test_model_modules_import_without_jax():
    mods = ["repro_torch.models.ssm", "repro_torch.models.mamba_lm",
            "repro_torch.models.griffin", "repro_torch.models.whisper",
            "repro_torch.models"]
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
            "import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from repro_torch.configs import ARCHS\n"
            "from repro_torch.models import get_model\n"
            "for cfg in ARCHS.values(): get_model(cfg)\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.')) "
            "for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')")
    res = _run(["-c", code])
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.mark.parametrize("name", ARCHS)
def test_entry_points_default_to_the_card(name):
    """Without a card the default ``device="cuda"`` raises in ``init`` and
    ``init_cache``; nothing moves to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    m = get_model(configs.reduced(configs.ARCHS[name]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init_cache(1, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ARCHS)
def test_engine_on_the_card_matches_the_cpu_port(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, m, params = _port_model(name, compute_dtype=torch.float32)
    cuda_params = tree_map(lambda t: t.to("cuda"), params)
    want = _drain(Engine(m, params, slots=3, max_len=48, device="cpu"),
                  _requests(Request, cfg.vocab, 5, 6, 5))
    got = _drain(Engine(m, cuda_params, slots=3, max_len=48, device="cuda"),
                 _requests(Request, cfg.vocab, 5, 6, 5))
    assert got == want
