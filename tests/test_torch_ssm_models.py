"""The port's ssm, hybrid and audio families against the JAX reference.

``falcon-mamba-7b`` (Mamba selective scan), ``recurrentgemma-9b`` (RG-LRU +
ring-buffer local attention) and ``whisper-base`` (encoder-decoder),
reduced, on the reference's initialised params (``convert.params_from_arrays``)
and the same seeded numpy inputs.  Tolerances:

* spec trees, shapes, dtypes, cache specs, a raised error: **exact**;
* at f32 compute (``compute_dtype=float32`` in both packages):
  ``full_logits``, ``loss_fn``, teacher-forced ``decode_step`` logits,
  prefill logits and the caches ``rtol=1e-4``, ``atol=1e-4`` — the same
  f32 arithmetic in another order: the in-chunk scan is a Hillis–Steele
  doubling scan where XLA's ``associative_scan`` recurses odd/even, and the
  transcendental functions may differ from XLA's in the last ulp (observed
  gaps are about 3e-6);
* bf16 cache leaves (the conv state prefill rounds from f32): one bf16
  ulp (``rtol=2**-7``) — two f32 values within the tolerance above may
  round to neighbouring bf16 values;
* the scan alone against a sequential float64 loop: ``rtol=1e-5``,
  ``atol=1e-6``;
* at bf16 compute (the default): the reference test's own tolerance
  between two evaluations (``test_models.test_decode_matches_train_forward``):
  top-1 agreement ≥ 0.9 and ``rtol=0.1``, ``atol=0.15``.

Whisper's decode is checked with the cross cache filled from the encoder
output, as the reference's test fills it.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import get_model as jget_model
from repro.models import griffin as jgriffin
from repro.models import ssm as jssm
from repro.models import whisper as jwhisper
from repro_torch import configs, convert
from repro_torch.models import common, get_model, griffin, ssm, whisper

ARCHS = ["falcon-mamba-7b", "recurrentgemma-9b", "whisper-base"]
RECURRENT = ["falcon-mamba-7b", "recurrentgemma-9b"]
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=0.1, atol=0.15)
F64_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_ULP = 2.0 ** -7      # one bf16 ulp, relative
B, T = 2, 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().cpu().numpy()
    return np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 else np.asarray(x)


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _cfgs(name, f32: bool, **kw):
    jc, tc = jconfigs.reduced(jconfigs.ARCHS[name]), configs.reduced(configs.ARCHS[name])
    if f32:
        jc = dataclasses.replace(jc, compute_dtype=jnp.float32)
        tc = dataclasses.replace(tc, compute_dtype=torch.float32)
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    """The reference's initialised params (f32) as numpy leaves."""
    jm = jget_model(jconfigs.reduced(jconfigs.ARCHS[name]))
    params, specs = jm.init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params), specs


def _jitted(m):
    """The reference model with its entry points under ``jax.jit``."""
    return dataclasses.replace(
        m, full_logits=jax.jit(m.full_logits), loss_fn=jax.jit(m.loss_fn),
        decode_step=jax.jit(m.decode_step),
        prefill=jax.jit(m.prefill, static_argnums=2))


@functools.lru_cache(maxsize=None)
def _pair(name, f32=True, **kw):
    """(ref model, ref params, port model, port params) on one weight set;
    cached, so the reference's jitted entry points compile once per config
    (no test writes into a params tree)."""
    jc, tc = _cfgs(name, f32, **kw)
    arrays, _ = _ref_params(name)
    return (_jitted(jget_model(jc)), jax.tree.map(jnp.asarray, arrays),
            get_model(tc), convert.params_from_arrays(arrays, device="cpu"))


def _batch(cfg, seed=1, b=B, t=T):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = rng.normal(size=(b, cfg.enc_frames, cfg.d_model)
                                   ).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.as_tensor(v) for k, v in out.items()})


@functools.partial(jax.jit, static_argnums=0)
def _ref_cross(jc, jp, frames):
    """The reference test's cross-cache fill (``test_models.py``)."""
    enc_out = jwhisper.encode(jc, jp, frames)
    acfg = jwhisper._acfg(jc)
    ks, vs = [], []
    for l in range(jc.n_layers):
        lp = jax.tree.map(lambda x, _l=l: x[_l], jp["dec"])
        kv = jattn.project_kv(lp["xattn"], enc_out, acfg,
                              jnp.zeros(enc_out.shape[:2], jnp.int32))
        ks.append(kv["k"]), vs.append(kv["v"])
    return {"k": jnp.stack(ks).astype(jc.compute_dtype),
            "v": jnp.stack(vs).astype(jc.compute_dtype)}


def _caches(jm, jp, tm, tp, jb, tb, b=B, max_len=T):
    """Fresh decode caches of both packages; whisper's cross K/V filled
    from each package's encoder."""
    jcache, tcache = jm.init_cache(b, max_len), tm.init_cache(b, max_len, device="cpu")
    if tm.cfg.family == "audio":
        jcache["layers"]["cross"] = _ref_cross(jm.cfg, jp, jb["frames"])
        enc_out = whisper.encode(tm.cfg, tp, tb["frames"])
        tcache["layers"]["cross"] = whisper.cross_cache(tm.cfg, tp, enc_out)
    return jcache, tcache


def _decode_all(m, params, cache, toks, as_input):
    steps = []
    for t in range(toks.shape[1]):
        logits, cache = m.decode_step(params, as_input(toks[:, t:t + 1]), cache)
        steps.append(_np(logits[:, 0, :]))
    return np.stack(steps, axis=1), cache


def _same_leaves(tcache, jcache, tol=None):
    """Leaf for leaf: shape and dtype equal; values within ``tol``, bf16
    leaves (a conv state rounded from f32 values that agree within ``tol``)
    within one bf16 ulp more."""
    def leaf(t, a):
        assert (tuple(t.shape), _dtype(t)) == (tuple(a.shape), _dtype(a))
        if tol is not None:
            got, want = _np(t), _np(a)
            if t.dtype == torch.bfloat16:
                np.testing.assert_allclose(got, want, rtol=BF16_ULP,
                                           atol=tol["atol"])
            else:
                np.testing.assert_allclose(got, want, **tol)
    common.tree_map(leaf, tcache, jcache)


# ===========================================================================
# structure
# ===========================================================================

@pytest.mark.parametrize("name", ARCHS)
def test_spec_tree_mirrors_params(name):
    cfg = configs.reduced(configs.ARCHS[name])
    params, specs = get_model(cfg).init(torch.Generator().manual_seed(0),
                                        device="cpu")
    p_leaves = common.tree_leaves(params)
    s_leaves = common.tree_leaves(specs, is_leaf=common.is_spec)
    assert len(p_leaves) == len(s_leaves)
    for p, s in zip(p_leaves, s_leaves):
        assert isinstance(p, torch.Tensor) and p.ndim == len(s)
    assert specs == _ref_params(name)[1]        # the reference's logical axes
    common.tree_map(lambda t, a: (tuple(t.shape), _dtype(t)) ==
                    (a.shape, _dtype(a)) or pytest.fail(name),
                    params, _ref_params(name)[0])


@pytest.mark.parametrize("name", ARCHS)
def test_meta_init_matches_concrete(name):
    m = get_model(configs.reduced(configs.ARCHS[name]))
    params, _ = m.init(torch.Generator().manual_seed(0), device="cpu")
    abstract, _ = m.init(None)
    shape = lambda x: (tuple(x.shape), x.dtype)
    assert common.tree_map(shape, params) == common.tree_map(shape, abstract)
    assert all(t.device.type == "meta" for t in common.tree_leaves(abstract))
    jm = jget_model(jconfigs.reduced(jconfigs.ARCHS[name]))
    assert m.cache_specs(2, 16) == jm.cache_specs(2, 16)
    _same_leaves(m.init_cache(2, 16, device="cpu"), jm.init_cache(2, 16))


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "whisper-base"])
def test_params_cross_packages_leaf_for_leaf(name):
    """Griffin's unstacked ``tail`` list and Whisper's ``enc`` / ``dec``
    stacks cross to the port and back exactly."""
    arrays, _ = _ref_params(name)
    tp = convert.params_from_arrays(arrays, device="cpu")
    if name == "recurrentgemma-9b":
        assert isinstance(tp["tail"], list) and len(tp["tail"]) == 1
        assert set(tp["periods"]) == {"a", "b", "c"}
    else:
        assert tp["enc"]["attn"]["wq"].shape[0] == 2 and "xattn" in tp["dec"]
    back = convert.params_to_arrays(tp)
    common.tree_map(lambda a, b: np.testing.assert_array_equal(a, b) or
                    (a.dtype == b.dtype or pytest.fail("dtype")), arrays, back)


def test_generator_seeds_the_init():
    m = get_model(configs.reduced(configs.ARCHS["falcon-mamba-7b"]))
    a, _ = m.init(torch.Generator().manual_seed(3), device="cpu")
    b, _ = m.init(torch.Generator().manual_seed(3), device="cpu")
    c, _ = m.init(torch.Generator().manual_seed(4), device="cpu")
    assert torch.equal(a["layers"]["mixer"]["in_proj"], b["layers"]["mixer"]["in_proj"])
    assert not torch.equal(a["embed"], c["embed"])


# ===========================================================================
# f32 compute: logits, loss, decode, caches
# ===========================================================================

@pytest.mark.parametrize("name", ARCHS)
def test_logits_match_reference_f32(name):
    jm, jp, tm, tp = _pair(name)
    jb, tb = _batch(tm.cfg)
    want = _np(jm.full_logits(jp, jb))
    np.testing.assert_allclose(_np(tm.full_logits(tp, tb)), want, **F32_TOL)
    np.testing.assert_allclose(float(tm.loss_fn(tp, tb)),
                               float(jm.loss_fn(jp, jb)), **F32_TOL)
    jcache, tcache = _caches(jm, jp, tm, tp, jb, tb)
    toks = np.array(jb["tokens"])
    ref, jcache = _decode_all(jm, jp, jcache, toks, jnp.asarray)
    got, tcache = _decode_all(tm, tp, tcache, toks, torch.as_tensor)
    np.testing.assert_allclose(got, ref, **F32_TOL)
    np.testing.assert_allclose(got, want, **F32_TOL)   # decode == full forward
    _same_leaves(tcache, jcache, F32_TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_matches_reference_f32(name):
    """Prefill's last logits and the cache it returns (whisper's: a fresh
    one, as the reference's), then two decode steps from it."""
    jm, jp, tm, tp = _pair(name)
    jb, tb = _batch(tm.cfg)
    P, max_len = T - 2, T + 4
    jpre = {k: v[:, :P] if k == "tokens" else v for k, v in jb.items()}
    tpre = {k: v[:, :P] if k == "tokens" else v for k, v in tb.items()}
    jl, jc = jm.prefill(jp, jpre, max_len)
    tl, tc = tm.prefill(tp, tpre, max_len)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32_TOL)
    assert int(tc["pos"]) == int(jc["pos"])
    _same_leaves(tc, jc, F32_TOL)
    toks = np.array(jb["tokens"])
    want, jc = _decode_all(jm, jp, jc, toks[:, P:], jnp.asarray)
    got, tc = _decode_all(tm, tp, tc, toks[:, P:], torch.as_tensor)
    np.testing.assert_allclose(got, want, **F32_TOL)
    _same_leaves(tc, jc, F32_TOL)


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", RECURRENT)
def test_conv_state_dtype_follows_the_reference(name, f32):
    """The conv state is bf16 in a fresh cache and after prefill; a decode
    step returns it in the compute dtype — in both packages."""
    jm, jp, tm, tp = _pair(name, f32=f32)
    jb, tb = _batch(tm.cfg)
    convs = lambda c: [l for l in common.tree_leaves(c) if l.ndim >= 3
                       and l.shape[-2] == tm.cfg.d_conv - 1]
    jl, jc = jm.prefill(jp, {"tokens": jb["tokens"][:, :4]}, T)
    tl, tc = tm.prefill(tp, {"tokens": tb["tokens"][:, :4]}, T)
    assert {_dtype(l) for l in convs(tc)} == {"bfloat16"}
    _same_leaves(tc, jc)
    _, jc = jm.decode_step(jp, jb["tokens"][:, 4:5], jc)
    _, tc = tm.decode_step(tp, tb["tokens"][:, 4:5], tc)
    assert {_dtype(l) for l in convs(tc)} == {"float32" if f32 else "bfloat16"}
    _same_leaves(tc, jc)


# ===========================================================================
# bf16 compute (the default)
# ===========================================================================

@pytest.mark.parametrize("name", ARCHS)
def test_bf16_matches_reference(name):
    """bf16 logits against the reference's, and the reference's decode vs
    full-forward test on the port."""
    jm, jp, tm, tp = _pair(name, f32=False)
    jb, tb = _batch(tm.cfg, seed=1, b=2, t=16)
    want = _np(jm.full_logits(jp, jb))
    got = _np(tm.full_logits(tp, tb))
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9
    np.testing.assert_allclose(got, want, **BF16_TOL)
    _, tcache = _caches(jm, jp, tm, tp, jb, tb, max_len=16)
    dec, _ = _decode_all(tm, tp, tcache, np.array(jb["tokens"]), torch.as_tensor)
    assert (dec.argmax(-1) == got.argmax(-1)).mean() > 0.9
    np.testing.assert_allclose(dec, got, **BF16_TOL)


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", RECURRENT, ids=["mamba", "griffin"])
def test_prefill_then_decode_continuity(name, f32):
    """prefill(prompt) -> decode continues like step-by-step decode (the
    reference test's mamba and griffin cases), and at f32 like the
    reference's."""
    jm, jp, tm, tp = _pair(name, f32=f32)
    P, EXTRA, MAXLEN = 6, 3, 16
    toks = np.random.default_rng(3).integers(1, tm.cfg.vocab, (2, P + EXTRA)
                                             ).astype(np.int32)
    tt = torch.as_tensor(toks)
    cache_a = tm.init_cache(2, MAXLEN, device="cpu")
    for t in range(P + EXTRA):
        logits_a, cache_a = tm.decode_step(tp, tt[:, t:t + 1], cache_a)
    _, cache_b = tm.prefill(tp, {"tokens": tt[:, :P]}, MAXLEN)
    for t in range(P, P + EXTRA):
        logits_b, cache_b = tm.decode_step(tp, tt[:, t:t + 1], cache_b)
    a, b = _np(logits_a[:, -1]), _np(logits_b[:, -1])
    assert (a.argmax(-1) == b.argmax(-1)).mean() == 1.0
    np.testing.assert_allclose(a, b, **BF16_TOL)
    if f32:
        _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :P])}, MAXLEN)
        for t in range(P, P + EXTRA):
            jl, jcache = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jcache)
        np.testing.assert_allclose(b, _np(jl[:, -1]), **F32_TOL)


# ===========================================================================
# the scan and the conv
# ===========================================================================

@pytest.mark.parametrize("S", [1, 256, 512])
def test_chunked_linear_scan(S):
    """One chunk, a full chunk, and two chunks with the carry across them:
    the reference's scan within F32_TOL and a sequential float64 loop within
    F64_TOL."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 3, 4)).astype(np.float32)
    b = rng.normal(size=(2, S, 3, 4)).astype(np.float32)
    h0 = rng.normal(size=(2, 3, 4)).astype(np.float32)
    got_all, got_last = ssm.chunked_linear_scan(
        torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(h0))
    want_all, want_last = jax.jit(jssm.chunked_linear_scan)(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    np.testing.assert_allclose(got_all.numpy(), np.asarray(want_all), **F32_TOL)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), **F32_TOL)
    h, seq = h0.astype(np.float64), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    np.testing.assert_allclose(got_all.numpy(), np.stack(seq, 1), **F64_TOL)
    np.testing.assert_array_equal(got_last.numpy(), got_all[:, -1].numpy())


@pytest.mark.parametrize("where", ["scan", "mamba prefill", "griffin forward"])
def test_seq_off_the_chunk_raises_in_both_packages(where):
    """S = 300 > CHUNK is no multiple of 256: both packages raise."""
    S = 300
    if where == "scan":
        z = np.zeros((1, S, 2), np.float32)
        with pytest.raises(ValueError, match="not a multiple of chunk"):
            jssm.chunked_linear_scan(jnp.asarray(z), jnp.asarray(z),
                                     jnp.zeros((1, 2)))
        with pytest.raises(ValueError, match="not a multiple of chunk"):
            ssm.chunked_linear_scan(torch.as_tensor(z), torch.as_tensor(z),
                                    torch.zeros(1, 2))
        return
    name = "falcon-mamba-7b" if where == "mamba prefill" else "recurrentgemma-9b"
    jm, jp, tm, tp = _pair(name)
    jb, tb = _batch(tm.cfg, b=1, t=S)
    call = (lambda m, p, bt: m.prefill(p, bt, S)) if name == "falcon-mamba-7b" \
        else (lambda m, p, bt: m.full_logits(p, bt))
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        call(jm, jp, jb)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        call(tm, tp, tb)


@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "state"])
def test_causal_conv1d(with_state):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    state = rng.normal(size=(2, 3, 6)).astype(np.float32) if with_state else None
    jy, jst = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                 None if state is None else
                                 jnp.asarray(state, jnp.bfloat16))
    ty, tst = ssm.causal_conv1d(torch.as_tensor(x), torch.as_tensor(w),
                                None if state is None else
                                torch.as_tensor(state).to(torch.bfloat16))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32_TOL)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    assert tst.dtype == torch.float32 and jst.dtype == jnp.float32


def test_softplus_is_logaddexp():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``: past F.softplus's
    threshold of 20 too, in f32 and bf16."""
    x = np.array([-40.0, -3.0, 0.0, 0.7, 19.9, 20.5, 35.0, 90.0], np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        got = _np(ssm.softplus(torch.as_tensor(x).to(tdt)))
        want = _np(jax.nn.softplus(jnp.asarray(x, jdt)))
        np.testing.assert_allclose(got, want, rtol=1e-6 if tdt == torch.float32
                                   else 1e-2)


# ===========================================================================
# griffin: the ring buffer and the long-sequence path
# ===========================================================================

def test_griffin_ring_decode_past_the_window():
    """24 decode steps at window 16: the ring wraps, the mask keeps the
    last 16 positions, logits as the reference's and as the full forward."""
    jm, jp, tm, tp = _pair("recurrentgemma-9b")
    assert tm.cfg.window == 16
    jb, tb = _batch(tm.cfg, seed=5, t=24)
    jcache, tcache = _caches(jm, jp, tm, tp, jb, tb, max_len=24)
    toks = np.array(jb["tokens"])
    want, jcache = _decode_all(jm, jp, jcache, toks, jnp.asarray)
    got, tcache = _decode_all(tm, tp, tcache, toks, torch.as_tensor)
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(got, _np(tm.full_logits(tp, tb)), **F32_TOL)
    _same_leaves(tcache, jcache, F32_TOL)
    assert int(tcache["pos"]) == 24


def test_griffin_prefill_longer_than_the_window():
    """prefill(40) keeps the last 16 keys at slot ``pos % 16``; decoding on
    from it equals the reference and continues step-by-step decode."""
    jm, jp, tm, tp = _pair("recurrentgemma-9b")
    jb, tb = _batch(tm.cfg, seed=6, t=44)
    P = 40
    jl, jc = jm.prefill(jp, {"tokens": jb["tokens"][:, :P]}, 64)
    tl, tc = tm.prefill(tp, {"tokens": tb["tokens"][:, :P]}, 64)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32_TOL)
    _same_leaves(tc, jc, F32_TOL)
    toks = np.array(jb["tokens"])
    got, _ = _decode_all(tm, tp, tc, toks[:, P:], torch.as_tensor)
    want, _ = _decode_all(jm, jp, jc, toks[:, P:], jnp.asarray)
    np.testing.assert_allclose(got, want, **F32_TOL)
    # step-by-step decode: prefill rounds the conv state to bf16 (both
    # packages), so the two paths agree to the continuity test's tolerance
    step, _ = _decode_all(tm, tp, tm.init_cache(B, 64, device="cpu"), toks,
                          torch.as_tensor)
    assert (got.argmax(-1) == step[:, P:].argmax(-1)).all()
    np.testing.assert_allclose(got, step[:, P:], **BF16_TOL)


def test_griffin_long_sequence_takes_forward_chunked(monkeypatch):
    """S > 2048 switches the local attention to ``forward_chunked``.  S =
    2304 (nine scan chunks) matches the reference; S = 2056 is no multiple
    of the RG-LRU's chunk and raises in both packages."""
    jc, tc = _cfgs("recurrentgemma-9b", f32=True)
    arrays, _ = _ref_params("recurrentgemma-9b")
    jp = jax.tree.map(jnp.asarray, arrays)
    tp = convert.params_from_arrays(arrays, device="cpu")
    calls = []
    real = griffin.attention.forward_chunked
    monkeypatch.setattr(griffin.attention, "forward_chunked",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jb, tb = _batch(tc, seed=7, b=1, t=2304)
    want = jax.jit(functools.partial(jgriffin.hidden_states, jc))(jp, jb)
    got = griffin.hidden_states(tc, tp, tb)
    assert len(calls) == 1
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    jb, tb = _batch(tc, seed=7, b=1, t=2056)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        jgriffin.hidden_states(jc, jp, jb)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        griffin.hidden_states(tc, tp, tb)


# ===========================================================================
# whisper: the position clamp and the empty prefill cache
# ===========================================================================

def test_whisper_decode_past_max_len_clamps_as_the_reference():
    """Past ``max_len`` the position row and the self-cache write clamp to
    the last row, in both packages."""
    jm, jp, tm, tp = _pair("whisper-base")
    jb, tb = _batch(tm.cfg, seed=8, t=7)
    jcache, tcache = _caches(jm, jp, tm, tp, jb, tb, max_len=4)
    toks = np.array(jb["tokens"])
    want, jcache = _decode_all(jm, jp, jcache, toks, jnp.asarray)
    got, tcache = _decode_all(tm, tp, tcache, toks, torch.as_tensor)
    np.testing.assert_allclose(got, want, **F32_TOL)
    assert int(tcache["pos"]) == int(jcache["pos"]) == 7
    _same_leaves(tcache, jcache, F32_TOL)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32", "int8"])
def test_whisper_prefill_returns_the_references_empty_cache(kv_quant):
    jm, jp, tm, tp = _pair("whisper-base", kv_quant=kv_quant)
    jb, tb = _batch(tm.cfg, seed=9)
    jl, jc = jm.prefill(jp, jb, 12)
    tl, tc = tm.prefill(tp, tb, 12)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32_TOL)
    _same_leaves(tc, jc)
    common.tree_map(lambda t, a: np.testing.assert_array_equal(_np(t), _np(a)),
                    tc, jc)
    fresh = tm.init_cache(B, 12, device="cpu")
    common.tree_map(lambda t, f: torch.equal(t, f) or pytest.fail("leaf"), tc, fresh)
