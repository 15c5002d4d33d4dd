"""The port's transformer-family models against the JAX reference.

The seven transformer-family archs (dense, MoE with MLA, VLM), reduced, on
the reference's initialised params (``convert.params_from_arrays``) and the
same seeded numpy inputs.  Tolerances:

* spec trees, shapes, dtypes, cache specs, routing under forced ties:
  **exact**;
* at f32 compute (``compute_dtype=float32`` in both packages):
  ``full_logits``, ``loss_fn``, ``prefill`` logits and cache, and
  teacher-forced ``decode_step`` logits ``rtol=1e-4``, ``atol=1e-4`` — the
  same f32 arithmetic, summed in another order, with RoPE's ``pow`` /
  ``cos`` / ``sin`` and ``rsqrt`` allowed to differ from XLA's in the last
  ulp (observed gaps are about 2e-6);
* int8 KV caches (``kv_quant``) equal, except entries whose unrounded value
  lies within 1e-4 of a rounding boundary, which may differ by one;
* at bf16 compute (the default): the reference test's own tolerance
  between two evaluations (``test_models.test_decode_matches_train_forward``):
  top-1 agreement ≥ 0.9 and ``rtol=0.1``, ``atol=0.15``.  XLA may keep
  bf16 intermediates in f32 where torch rounds each op, so a bf16 router
  score can land one ulp apart and an MoE top-k can flip on a near-tie;
  a token whose routing differs in some layer must show such a near-tie
  (its reference margin between the swapped experts within the measured
  score gap), and only the other tokens are held to the tolerance.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models import get_model as jget_model
from repro.models import transformer as jtransformer
from repro_torch import configs, convert
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import attention, ffn, get_model, input_specs, make_batch
from repro_torch.models import common, transformer

TRANSFORMER_ARCHS = [n for n, c in configs.ARCHS.items()
                     if c.family in ("dense", "moe", "vlm")]
MOE_ARCHS = [n for n in TRANSFORMER_ARCHS if configs.ARCHS[n].moe]
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=0.1, atol=0.15)
B, T = 2, 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().cpu().numpy()
    return np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 else np.asarray(x)


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
    """The reference model with its entry points under ``jax.jit``, as its
    ``Engine`` runs them (an eager call re-traces its layer scan)."""
    return dataclasses.replace(
        m, full_logits=jax.jit(m.full_logits), loss_fn=jax.jit(m.loss_fn),
        decode_step=jax.jit(m.decode_step),
        prefill=jax.jit(m.prefill, static_argnums=2))


def _pair(name, f32=True, **kw):
    """(ref model, ref params, port model, port params) on one weight set."""
    jc, tc = _cfgs(name, f32, **kw)
    arrays, _ = _ref_params(name)
    return (_jitted(jget_model(jc)), jax.tree.map(jnp.asarray, arrays),
            get_model(tc), convert.params_from_arrays(arrays, device="cpu"))


def _batch(cfg, seed=1, b=B, t=T):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)}
    if cfg.prefix_tokens:
        out["prefix_embeds"] = rng.normal(
            size=(b, cfg.prefix_tokens, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.as_tensor(v) for k, v in out.items()})


def _decode_all(m, params, cache, toks, as_input):
    steps = []
    for t in range(toks.shape[1]):
        logits, cache = m.decode_step(params, as_input(toks[:, t:t + 1]), cache)
        steps.append(_np(logits[:, 0, :]))
    return np.stack(steps, axis=1), cache


# ===========================================================================
# structure
# ===========================================================================

@pytest.mark.parametrize("name", TRANSFORMER_ARCHS)
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
    ref = _ref_params(name)[0]
    common.tree_map(lambda t, a: (tuple(t.shape), str(t.dtype)) ==
                    (a.shape, "torch." + str(a.dtype)) or pytest.fail(name),
                    params, ref)


@pytest.mark.parametrize("name", TRANSFORMER_ARCHS)
def test_meta_init_matches_concrete(name):
    m = get_model(configs.reduced(configs.ARCHS[name]))
    params, _ = m.init(torch.Generator().manual_seed(0), device="cpu")
    abstract, _ = m.init(None)
    shape = lambda x: (tuple(x.shape), x.dtype)
    assert common.tree_map(shape, params) == common.tree_map(shape, abstract)
    assert all(t.device.type == "meta" for t in common.tree_leaves(abstract))
    jm = jget_model(jconfigs.reduced(jconfigs.ARCHS[name]))
    assert m.cache_specs(2, 16) == jm.cache_specs(2, 16)


def test_params_cross_packages_leaf_for_leaf():
    """The reference's params tree -> the port's -> numpy again, exactly;
    the port's own init crosses back the same way."""
    arrays, _ = _ref_params("deepseek-v3-671b")
    tp = convert.params_from_arrays(arrays, device="cpu")
    assert isinstance(tp["groups"], list) and len(tp["groups"]) == 2
    back = convert.params_to_arrays(tp)
    common.tree_map(lambda a, b: np.testing.assert_array_equal(a, b) or
                    (a.dtype == b.dtype or pytest.fail("dtype")), arrays, back)
    m = get_model(configs.reduced(configs.ARCHS["qwen3-4b"]))
    own, _ = m.init(torch.Generator().manual_seed(1), device="cpu")
    again = convert.params_from_arrays(convert.params_to_arrays(own), device="cpu")
    common.tree_map(lambda a, b: torch.equal(a, b) or pytest.fail("leaf"), own, again)


def test_generator_seeds_the_init():
    m = get_model(configs.reduced(configs.ARCHS["qwen3-4b"]))
    a, _ = m.init(torch.Generator().manual_seed(3), device="cpu")
    b, _ = m.init(torch.Generator().manual_seed(3), device="cpu")
    c, _ = m.init(torch.Generator().manual_seed(4), device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])


def test_input_specs_and_make_batch():
    cfg = configs.reduced(configs.ARCHS["paligemma-3b"])
    shape = ShapeConfig("t", "train", 32, 2)
    specs = input_specs(cfg, shape)
    assert {k: (tuple(v.shape), v.dtype, v.device.type) for k, v in specs.items()} == {
        "tokens": ((2, 32), torch.int32, "meta"),
        "prefix_embeds": ((2, cfg.prefix_tokens, cfg.d_model), torch.float32, "meta")}
    batch = make_batch(cfg, shape, torch.Generator().manual_seed(0), device="cpu")
    assert batch["tokens"].dtype == torch.int32
    assert int(batch["tokens"].min()) >= 0 and int(batch["tokens"].max()) < cfg.vocab
    assert input_specs(cfg, ShapeConfig("d", "decode", 64, 4))["tokens"].shape == (4, 1)


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "recurrentgemma-9b",
                                  "whisper-base"])
def test_get_model_raises_for_unported_families(name):
    """The ssm, hybrid and audio families are ported now: ``get_model``
    builds each with the reference's entry points (whisper's prefill being
    the zoo's), and only a family the reference lacks raises."""
    cfg = configs.reduced(configs.ARCHS[name])
    m = get_model(cfg)
    jm = jget_model(jconfigs.reduced(jconfigs.ARCHS[name]))
    assert m.cfg is cfg and m.prefill is not None
    assert m.cache_specs(2, 16) == jm.cache_specs(2, 16)
    want = "_whisper_prefill" if cfg.family == "audio" else "prefill"
    assert m.prefill.func.__name__ == jm.prefill.func.__name__ == want
    with pytest.raises(KeyError):
        get_model(dataclasses.replace(cfg, family="unported"))


def test_sharding_ctx_resolve_matches_reference():
    mesh = types.SimpleNamespace(shape={"pod": 1, "data": 4, "model": 8},
                                 axis_names=("pod", "data", "model"))
    cases = [(("batch", "seq", "embed"), (8, 16, 960)),
             (("embed_w", "heads"), (960, 15 * 64)),
             (("embed_w", "heads"), (960, 16 * 64)),
             (("layers", "vocab", "embed"), (32, 49152, 960)),
             (("experts", "embed_w", "mlp"), (40, 1536, 512)),
             (("heads", "kv_heads"), (64, 64))]
    j, t = jcommon.ShardingCtx(), common.ShardingCtx()
    j.mesh = t.mesh = mesh
    for logical, shape in cases:
        assert tuple(j.resolve(logical, shape)) == t.resolve(logical, shape)
    x = torch.zeros(2, 3)
    assert common.shard(x, "batch", "embed") is x   # no mesh: identity


# ===========================================================================
# f32 compute: logits, loss, prefill, decode
# ===========================================================================

@pytest.mark.parametrize("name", TRANSFORMER_ARCHS)
def test_logits_match_reference_f32(name):
    jm, jp, tm, tp = _pair(name)
    jb, tb = _batch(tm.cfg)
    np.testing.assert_allclose(_np(tm.full_logits(tp, tb)),
                               _np(jm.full_logits(jp, jb)), **F32_TOL)
    np.testing.assert_allclose(float(tm.loss_fn(tp, tb)),
                               float(jm.loss_fn(jp, jb)), **F32_TOL)
    # teacher-forced decode from an empty cache
    toks = np.asarray(jb["tokens"])
    if not tm.cfg.prefix_tokens:
        want, _ = _decode_all(jm, jp, jm.init_cache(B, T), toks, jnp.asarray)
        got, _ = _decode_all(tm, tp, tm.init_cache(B, T, device="cpu"), toks,
                             torch.as_tensor)
        np.testing.assert_allclose(got, want, **F32_TOL)
    # prefill: last logits and the cache it builds, then two decode steps
    P, max_len = T - 2, T + 4
    jpre = {k: v[:, :P] if k == "tokens" else v for k, v in jb.items()}
    tpre = {k: v[:, :P] if k == "tokens" else v for k, v in tb.items()}
    jl, jc = jm.prefill(jp, jpre, max_len)
    tl, tc = tm.prefill(tp, tpre, max_len)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32_TOL)
    assert int(tc["pos"]) == int(jc["pos"])
    common.tree_map(lambda t, a: np.testing.assert_allclose(_np(t), _np(a), **F32_TOL),
                    tc["layers"], jc["layers"])
    want, _ = _decode_all(jm, jp, jc, toks[:, P:], jnp.asarray)
    got, _ = _decode_all(tm, tp, tc, toks[:, P:], torch.as_tensor)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_full_width_smollm_depth2():
    """smollm-360m at its published widths (GQA group 3, head_dim 64,
    d_ff 2560, vocab 49152), depth cut to 2: B = 1, 8 tokens (about 8 s
    serially)."""
    jc = dataclasses.replace(jconfigs.ARCHS["smollm-360m"], n_layers=2,
                             compute_dtype=jnp.float32)
    tc = dataclasses.replace(configs.ARCHS["smollm-360m"], n_layers=2,
                             compute_dtype=torch.float32)
    assert (tc.n_heads // tc.n_kv, tc.head_dim, tc.d_model) == (3, 64, 960)
    jm, tm = _jitted(jget_model(jc)), get_model(tc)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tp = convert.params_from_arrays(jax.tree.map(np.asarray, jp), device="cpu")
    jb, tb = _batch(tc, seed=2, b=1, t=8)
    want = _np(jm.full_logits(jp, jb))
    np.testing.assert_allclose(_np(tm.full_logits(tp, tb)), want, **F32_TOL)
    toks = np.asarray(jb["tokens"])
    got, _ = _decode_all(tm, tp, tm.init_cache(1, 8, device="cpu"), toks,
                         torch.as_tensor)
    ref, _ = _decode_all(jm, jp, jm.init_cache(1, 8), toks, jnp.asarray)
    np.testing.assert_allclose(got, ref, **F32_TOL)
    np.testing.assert_allclose(got, want, **F32_TOL)


# ===========================================================================
# int8 KV residency
# ===========================================================================

@pytest.mark.parametrize("name", [n for n in TRANSFORMER_ARCHS
                                  if not configs.ARCHS[n].prefix_tokens])
def test_int8_cache_matches_reference(name, monkeypatch):
    jm, jp, tm, tp = _pair(name, kv_quant=True)
    jb, _ = _batch(tm.cfg, seed=4)
    toks = np.asarray(jb["tokens"])
    written = []                       # the port's unrounded q per write
    real_write = attention._cache_write

    def spy(cache, name_, val, pos):
        buf = cache[name_]
        if buf.dtype == torch.int8:
            written.append((name_, int(pos),
                            (val.float() / attention._scale_for(cache, name_, buf))[:, 0]))
        return real_write(cache, name_, val, pos)

    monkeypatch.setattr(attention, "_cache_write", spy)
    want_logits, jcache = _decode_all(jm, jp, jm.init_cache(B, T), toks, jnp.asarray)
    got_logits, tcache = _decode_all(tm, tp, tm.init_cache(B, T, device="cpu"),
                                     toks, torch.as_tensor)
    # where each write landed: (group, layer) in call order per step
    layer_slots = [(g, l) for g, (n, _) in enumerate(transformer.layer_groups(tm.cfg))
                   for l in range(n)]
    names = ["latent"] if tm.cfg.mla else ["k", "v"]
    assert len(written) == T * len(layer_slots) * len(names)
    it = iter(written)
    boundary = {}
    for t in range(T):
        for g, l in layer_slots:
            for nm in names:
                name_, pos, q = next(it)
                assert (name_, pos) == (nm, t)
                frac = (q.abs() - q.abs().floor() - 0.5).abs()
                boundary[(g, nm, l, t)] = (frac < 1e-4) | (q.abs() > 127.4)
    n_near = 0
    for g, (jg, tg) in enumerate(zip(jcache["layers"], tcache["layers"])):
        for nm in names:
            a, b = np.asarray(jg[nm]), tg[nm].numpy()
            assert a.dtype == b.dtype == np.int8
            for (gg, n2, l, t), near in boundary.items():
                if gg != g or n2 != nm:
                    continue
                diff = np.abs(a[l, :, t].astype(int) - b[l, :, t].astype(int))
                near = near.numpy()
                n_near += int(near.sum())
                assert (diff[~near] == 0).all(), (nm, l, t)
                assert (diff[near] <= 1).all(), (nm, l, t)
    np.testing.assert_allclose(got_logits, want_logits, **F32_TOL)


def test_int8_cache_write_rounds_half_to_even():
    """``_cache_write`` alone: round half to even, clip to ±127, the division
    kept (no reciprocal multiply), bitwise the reference's."""
    cfg = jattn.AttnCfg(d_model=8, n_heads=2, n_kv=2, head_dim=4, kv_quant=True)
    tcfg = attention.AttnCfg(d_model=8, n_heads=2, n_kv=2, head_dim=4, kv_quant=True)
    rng = np.random.default_rng(0)
    val = rng.normal(0, 60, (3, 1, 2, 4)).astype(np.float32)
    val.reshape(-1)[:6] = [0.5, 1.5, 2.5, -0.5, -2.5, 300.0]
    scale = np.array([1.0, 0.7], np.float32)
    jc = jattn.init_cache(cfg, 3, 5)
    jc = dict(jc, k_scale=jnp.asarray(scale))
    tc = attention.init_cache(tcfg, 3, 5, device="cpu")
    tc = dict(tc, k_scale=torch.as_tensor(scale))
    for pos in (0, 4, 7):       # 7 > max_len - 1: the write clamps to row 4
        want = np.asarray(jattn._cache_write(jc, "k", jnp.asarray(val), pos))
        got = attention._cache_write(tc, "k", torch.as_tensor(val), pos).numpy()
        np.testing.assert_array_equal(got, want)
    assert list(got[:, 4].reshape(-1)[:6]) == [0, 2, 2, 0, -4, 127]  # -2.5 / 0.7


# ===========================================================================
# MoE routing
# ===========================================================================

@pytest.mark.parametrize("name", MOE_ARCHS)
@pytest.mark.parametrize("tied", [False, True], ids=["random", "forced-tie"])
def test_moe_expert_idx_matches_reference(name, tied):
    """Top-k experts equal the reference's ``lax.top_k`` (the lower index
    first among equal scores), and the MoE output equals the reference's."""
    jc, tc = _cfgs(name, f32=True)
    jf, tf = jtransformer._ffn_cfg(jc, "moe"), transformer._ffn_cfg(tc, "moe")
    arrays, _ = _ref_params(name)
    p = {k: v[0] for k, v in arrays["groups"][-1]["ffn"].items()
         if k != "shared"}
    if "shared" in arrays["groups"][-1]["ffn"]:
        p["shared"] = {k: v[0] for k, v in arrays["groups"][-1]["ffn"]["shared"].items()}
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, jc.d_model)).astype(np.float32)
    if tied:   # experts 1 and 3 (and 2 and 5) get identical router columns
        p["router"] = p["router"].copy()
        p["router"][:, 3] = p["router"][:, 1]
        p["router"][:, 5] = p["router"][:, 2]
    jp = jax.tree.map(jnp.asarray, p)
    tp = convert.params_from_arrays(p, device="cpu")
    xt = x.reshape(-1, jc.d_model)
    scores = jnp.asarray(xt) @ jp["router"]
    probs = jax.nn.softmax(scores, -1) if jf.router_softmax else jax.nn.sigmoid(scores)
    want_vals, want_idx = jax.lax.top_k(probs, jf.top_k)
    got_vals, got_idx = ffn.route(tp, torch.as_tensor(xt), tf)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    if tied:   # a tied pair: the higher index only after the lower one
        idx = got_idx.numpy()
        assert np.isin(idx, [1, 2, 3, 5]).any()
        for lo, hi in ((1, 3), (2, 5)):
            for row in idx:
                if hi in row:
                    assert lo in row and list(row).index(lo) < list(row).index(hi)
    np.testing.assert_allclose(
        _np(ffn.moe(tp, torch.as_tensor(x), tf)),
        _np(jffn.moe(jp, jnp.asarray(x), jf)), rtol=1e-5, atol=1e-5)


def test_moe_tie_breaks_to_lower_index():
    probs = torch.tensor([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]])
    cfg = ffn.FfnCfg(d_model=4, d_ff=2, moe=True, n_experts=4, top_k=2)
    p = {"router": torch.eye(4)}
    _, idx = ffn.route(p, torch.log(probs), cfg)
    assert idx.tolist() == [[1, 2], [0, 1]]
    assert np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()), 2)[1]).tolist() == \
        [[1, 2], [0, 1]]


# ===========================================================================
# bf16 compute (the default)
# ===========================================================================

def _record_routing(monkeypatch, jax_side: bool, out: list):
    """Record each MoE layer's router scores and chosen experts."""
    if jax_side:   # the layer scan is traced: read the values at run time
        real = jax.lax.top_k

        def top_k(probs, k):
            vals, idx = real(probs, k)
            jax.debug.callback(lambda p, i: out.append((np.asarray(p), np.asarray(i))),
                               probs, idx, ordered=True)
            return vals, idx
        monkeypatch.setattr(jax.lax, "top_k", top_k)
    else:
        real_route = ffn.route

        def route(p, xt, cfg):
            vals, idx = real_route(p, xt, cfg)
            s = (xt @ p["router"]).float()
            probs = torch.softmax(s, -1) if cfg.router_softmax else torch.sigmoid(s)
            out.append((probs.numpy(), idx.numpy()))
            return vals, idx
        monkeypatch.setattr(ffn, "route", route)


@pytest.mark.parametrize("name", TRANSFORMER_ARCHS)
def test_bf16_matches_reference(name, monkeypatch):
    jm, jp, tm, tp = _pair(name, f32=False)
    jb, tb = _batch(tm.cfg, seed=1, b=2, t=16)
    jr, tr = [], []
    _record_routing(monkeypatch, True, jr)
    _record_routing(monkeypatch, False, tr)
    want = _np(jm.full_logits(jp, jb))
    got = _np(tm.full_logits(tp, tb))
    ok_tokens = np.ones(want.shape[:2], bool)
    P = tm.cfg.prefix_tokens
    assert len(jr) == len(tr)
    for (jprobs, jidx), (tprobs, tidx) in zip(jr, tr):
        flipped = (np.sort(jidx, -1) != np.sort(tidx, -1)).any(-1)
        gap = np.abs(jprobs - tprobs).max(-1)
        for tok in np.flatnonzero(flipped):
            swapped = np.setxor1d(jidx[tok], tidx[tok])
            margin = np.ptp(jprobs[tok, swapped])
            assert margin <= 2 * gap[tok], (name, tok, margin, gap[tok])
        per_seq = flipped.reshape(want.shape[0], -1)[:, P:]
        ok_tokens &= ~per_seq
    assert ok_tokens.mean() >= 0.75, ok_tokens.mean()
    agree = (got.argmax(-1) == want.argmax(-1))[ok_tokens].mean()
    assert agree >= 0.9, agree
    np.testing.assert_allclose(got[ok_tokens], want[ok_tokens], **BF16_TOL)


# ===========================================================================
# the reference's model tests, on the port
# ===========================================================================

def test_vlm_prefix_handling():
    jm, jp, tm, tp = _pair("paligemma-3b", f32=False)
    cfg = tm.cfg
    batch = make_batch(cfg, ShapeConfig("t", "train", 32, 2),
                       torch.Generator().manual_seed(0), device="cpu")
    assert batch["prefix_embeds"].shape == (2, cfg.prefix_tokens, cfg.d_model)
    assert np.isfinite(float(tm.loss_fn(tp, batch)))
    assert tm.full_logits(tp, batch).shape == (2, 32, cfg.vocab)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    np.testing.assert_allclose(float(tm.loss_fn(tp, batch)),
                               float(jm.loss_fn(jp, jbatch)), rtol=0.02)


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
def test_prefill_then_decode_continuity(f32):
    """prefill(prompt) -> decode continues exactly like step-by-step decode
    (the reference test's transformer case), and at f32 like the
    reference's."""
    jm, jp, tm, tp = _pair("qwen3-4b", f32=f32)
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
# attention variants the seven archs reach only at long prefill
# ===========================================================================

@pytest.mark.parametrize("window", [None, 24], ids=["full", "window"])
@pytest.mark.parametrize("mla", [False, True], ids=["gqa", "mla"])
def test_forward_chunked_and_cross_match_reference(window, mla):
    kw = dict(d_model=32, n_heads=4, n_kv=2, head_dim=8, window=window,
              qk_norm=not mla)
    if mla:
        kw.update(mla=True, q_lora=16, kv_lora=8, qk_nope=8, qk_rope=4, v_dim=8,
                  window=None)
    jcfg, tcfg = jattn.AttnCfg(**kw), attention.AttnCfg(**kw)
    b = jcommon.Builder(jax.random.PRNGKey(1))
    p = jax.tree.map(np.asarray, jcommon.Builder.split(jattn.init(b, jcfg))[0])
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 128, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(128, dtype=np.int32), (2, 128))
    jp, tp = jax.tree.map(jnp.asarray, p), convert.params_from_arrays(p, device="cpu")
    want = jattn.forward_chunked(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), q_chunk=64)
    got = attention.forward_chunked(tp, torch.as_tensor(x), tcfg,
                                    torch.as_tensor(pos), q_chunk=64)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    full = attention.forward(tp, torch.as_tensor(x), tcfg, torch.as_tensor(pos))
    np.testing.assert_allclose(_np(got), _np(full), **F32_TOL)
    if not mla:
        src = rng.normal(size=(2, 10, 32)).astype(np.float32)
        np.testing.assert_allclose(
            _np(attention.cross_forward(tp, torch.as_tensor(x[:, :8]),
                                        torch.as_tensor(src), tcfg)),
            _np(jattn.cross_forward(jp, jnp.asarray(x[:, :8]), jnp.asarray(src), jcfg)),
            **F32_TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(
                _np(attention.project_kv(tp, torch.as_tensor(x), tcfg,
                                         torch.as_tensor(pos))[key]),
                _np(jattn.project_kv(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))[key]),
                **F32_TOL)


def test_common_numerics_match_reference():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    g = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 5)).astype(np.int32)
    pairs = [
        (common.rms_norm(torch.as_tensor(x), torch.as_tensor(g)),
         jcommon.rms_norm(jnp.asarray(x), jnp.asarray(g))),
        (common.rope(torch.as_tensor(x), torch.as_tensor(pos), 1e6),
         jcommon.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        (common.swiglu(torch.as_tensor(x), torch.as_tensor(x[::-1].copy())),
         jcommon.swiglu(jnp.asarray(x), jnp.asarray(x[::-1].copy()))),
        (common.gelu_glu(torch.as_tensor(x), torch.as_tensor(x[::-1].copy())),
         jcommon.gelu_glu(jnp.asarray(x), jnp.asarray(x[::-1].copy()))),
        (common.sinusoidal_positions(12, 8), jcommon.sinusoidal_positions(12, 8)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    for window, off in ((None, 0), (3, 2)):
        np.testing.assert_array_equal(
            common.causal_mask(4, 6, window=window, q_offset=off).numpy(),
            np.asarray(jcommon.causal_mask(4, 6, window=window, q_offset=off)))
    xb = torch.as_tensor(x).to(torch.bfloat16)
    assert common.rms_norm(xb, torch.as_tensor(g)).dtype == torch.bfloat16
