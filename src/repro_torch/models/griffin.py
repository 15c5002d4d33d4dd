"""RecurrentGemma-style hybrid LM (Griffin): RG-LRU + local attention, 1:2.

Layer pattern: (recurrent, recurrent, local-attention) repeated; each layer
is temporal-mix + GeGLU MLP with pre-norms.  38 layers = 12 full periods
(stacked, keyed ``a`` / ``b`` / ``c``) + 2 trailing recurrent layers (an
unstacked ``tail`` list).  Local attention uses a *ring buffer* KV cache of
exactly ``window`` slots in the compute dtype (it ignores ``kv_quant``, as
the reference's does), so decode memory is O(window); with the RG-LRU's
O(1) state, decode memory does not grow with the context.
"""
from __future__ import annotations

import torch

from . import attention, ffn, ssm
from .common import (Builder, cast_tree, layer_slice, remat, resolve_device,
                     rms_norm, stack_layers, stacked_spec, tree_map,
                     unstack_layers)
from .transformer import (LONG_PREFILL, embed_tokens, logits_fn,
                          seq_positions, token_loss)

PERIOD = ("rec", "rec", "attn")


def _acfg(cfg) -> attention.AttnCfg:
    return attention.AttnCfg(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        window=cfg.window, kv_quant=cfg.kv_quant)


def _rcfg(cfg) -> ssm.RGLRUCfg:
    return ssm.RGLRUCfg(d_model=cfg.d_model, lru_width=cfg.lru_width or cfg.d_model)


def _fcfg(cfg) -> ffn.FfnCfg:
    return ffn.FfnCfg(cfg.d_model, cfg.d_ff, act="gelu")


def _pattern(cfg):
    n_periods = cfg.n_layers // len(PERIOD)
    remainder = tuple(PERIOD[: cfg.n_layers % len(PERIOD)])
    return n_periods, remainder


def init(cfg, generator: torch.Generator | None, device="cuda"):
    """Returns (params, logical-spec tree).  ``generator=None`` gives
    ``meta`` tensors of the concrete shapes and dtypes."""
    b = Builder(generator, dtype=cfg.param_dtype,
                device="meta" if generator is None else resolve_device(device))

    def mix_layer(kind: str):
        mixer = (ssm.init_rglru(b, _rcfg(cfg)) if kind == "rec"
                 else attention.init(b, _acfg(cfg)))
        return {
            "ln1": b.param((cfg.d_model,), ("embed",), init="zeros"),
            "mixer": mixer,
            "ln2": b.param((cfg.d_model,), ("embed",), init="zeros"),
            "mlp": ffn.init_dense(b, _fcfg(cfg)),
        }

    n_periods, remainder = _pattern(cfg)
    periods = [{k: mix_layer(k2) for k, k2 in zip("abc", PERIOD)}
               for _ in range(n_periods)]
    vals = [Builder.split(p)[0] for p in periods]
    spec = stacked_spec(Builder.split(periods[0])[1])

    tree = {
        "embed": b.param((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                         scale=1.0 / cfg.d_model ** 0.5),
        "ln_f": b.param((cfg.d_model,), ("embed",), init="zeros"),
        "lm_head": b.param((cfg.d_model, cfg.vocab), ("embed_w", "vocab")),
    }
    params, specs = Builder.split(tree)
    params["periods"] = stack_layers(vals)
    specs["periods"] = spec
    tail = [Builder.split(mix_layer(k)) for k in remainder]
    params["tail"] = [t[0] for t in tail]
    specs["tail"] = [t[1] for t in tail]
    return params, specs


def _mix_forward(cfg, kind: str, lp, x, positions, long_seq: bool):
    lp = cast_tree(lp, cfg.compute_dtype)
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if kind == "rec":
        h = ssm.rglru(lp["mixer"], h, _rcfg(cfg))
    elif long_seq:
        h = attention.forward_chunked(lp["mixer"], h, _acfg(cfg), positions)
    else:
        h = attention.forward(lp["mixer"], h, _acfg(cfg), positions)
    x = x + h
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + ffn.dense(lp["mlp"], h, _fcfg(cfg))


def hidden_states(cfg, params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
    x = embed_tokens(cfg, params, batch["tokens"])
    B, S, _ = x.shape
    positions = seq_positions(B, S, x.device)
    long_seq = S > LONG_PREFILL
    _, remainder = _pattern(cfg)

    def period_step(pp, x):
        for key, kind in zip("abc", PERIOD):
            x = _mix_forward(cfg, kind, pp[key], x, positions, long_seq)
        return x

    for pp in unstack_layers(params["periods"]):
        x = remat(cfg, period_step, pp, x)
    for lp, kind in zip(params["tail"], remainder):
        x = _mix_forward(cfg, kind, lp, x, positions, long_seq)
    return rms_norm(x, params["ln_f"], cfg.norm_eps)


def full_logits(cfg, params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
    return logits_fn(cfg, params, hidden_states(cfg, params, batch)).float()


def loss_fn(cfg, params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
    return token_loss(cfg, params, hidden_states(cfg, params, batch),
                      batch["tokens"])


# ---------------------------------------------------------------------------
# decode: ring-buffer local KV + RG-LRU state
# ---------------------------------------------------------------------------

def _ring_cache(cfg, batch: int, device):
    acfg = _acfg(cfg)
    shape = (batch, cfg.window, acfg.n_kv, acfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


def _attn_ring_decode(cfg, lp, x, lc, pos):
    """One-token local attention over a ``window``-slot ring buffer.  The
    slot and the mask come from the ``pos`` tensor on the device: no read
    on the host."""
    acfg = _acfg(cfg)
    B = x.shape[0]
    w = cfg.window
    positions = pos.to(torch.int32).expand(B, 1)
    q, k_new, v_new = attention._project_qkv(lp, x, acfg, positions)
    slot = (pos % w).reshape(1).long()
    k = lc["k"].index_copy(1, slot, k_new.to(lc["k"].dtype))
    v = lc["v"].index_copy(1, slot, v_new.to(lc["v"].dtype))
    # slot s holds absolute position: the largest t <= pos with t % w == s
    slots = torch.arange(w, device=x.device)
    abs_pos = pos - ((pos - slots) % w)
    valid = (abs_pos >= 0) & (abs_pos <= pos) & (abs_pos > pos - w)
    out = attention.sdpa(q, k.to(q.dtype), v.to(q.dtype),
                         valid[None, None, :], 1.0 / acfg.head_dim ** 0.5)
    out = out.reshape(B, 1, acfg.n_heads * acfg.head_dim)
    return out @ lp["wo"], {"k": k, "v": v}


def _mix_decode(cfg, kind: str, lp, x, lc, pos):
    lp = cast_tree(lp, cfg.compute_dtype)
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if kind == "rec":
        h, lc = ssm.rglru_decode(lp["mixer"], h, _rcfg(cfg), lc)
    else:
        h, lc = _attn_ring_decode(cfg, lp["mixer"], h, lc, pos)
    x = x + h
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    x = x + ffn.dense(lp["mlp"], h, _fcfg(cfg))
    return x, lc


def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    """max_len only bounds the ring window (decode memory is O(window))."""
    device = resolve_device(device)
    n_periods, remainder = _pattern(cfg)
    rec = ssm.rglru_state(_rcfg(cfg), batch, device=device)
    ring = _ring_cache(cfg, batch, device)
    one = {"a": rec, "b": rec, "c": ring}
    periods = tree_map(lambda l: l[None].repeat((n_periods,) + (1,) * l.ndim), one)
    tail = [dict(rec) if k == "rec" else dict(ring) for k in remainder]
    return {"periods": periods, "tail": tail,
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def cache_specs(cfg, batch: int, max_len: int):
    def spec_of(l):
        if l.ndim == 5:      # (P, B, W, kv, hd) ring
            return ("layers", "batch", None, "kv_heads", None)
        if l.ndim == 4:      # (B, W, kv, hd) tail ring / (P, B, K-1, width) conv
            return (None, "batch", None, "mlp")
        if l.ndim == 3:      # (P, B, width) rnn state
            return ("layers", "batch", "mlp")
        if l.ndim == 2:      # tail rnn (B, width)
            return ("batch", "mlp")
        return tuple(None for _ in l.shape)

    return tree_map(spec_of, init_cache(cfg, batch, max_len, device="meta"))


def prefill(cfg, params, batch: dict[str, torch.Tensor], max_len: int):
    """Full-sequence forward that also builds the decode state: RG-LRU final
    states (conv state cast back to bf16) + ring KV buffers holding the last
    ``window`` positions at slot ``pos % window``."""
    x = embed_tokens(cfg, params, batch["tokens"])
    B, S, _ = x.shape
    positions = seq_positions(B, S, x.device)
    long_seq = S > LONG_PREFILL
    w = cfg.window
    acfg = _acfg(cfg)

    def mix_prefill(kind, lp, carry):
        lp_c = cast_tree(lp, cfg.compute_dtype)
        h = rms_norm(carry, lp_c["ln1"], cfg.norm_eps)
        if kind == "rec":
            y, conv_s, rnn_s = ssm._rglru_core(lp_c["mixer"], h, _rcfg(cfg),
                                               None, None)
            state = {"conv": conv_s.to(torch.bfloat16), "rnn": rnn_s}
        else:
            if long_seq:
                y = attention.forward_chunked(lp_c["mixer"], h, acfg, positions)
            else:
                y = attention.forward(lp_c["mixer"], h, acfg, positions)
            kv = attention.project_kv(lp_c["mixer"], h, acfg, positions)
            take = min(w, S)
            slots = torch.arange(S - take, S, device=x.device) % w
            state = {}
            for name in ("k", "v"):
                ring = torch.zeros((B, w) + kv[name].shape[2:],
                                   dtype=cfg.compute_dtype, device=x.device)
                ring[:, slots] = kv[name][:, S - take:].to(cfg.compute_dtype)
                state[name] = ring
        carry = carry + y
        h = rms_norm(carry, lp_c["ln2"], cfg.norm_eps)
        carry = carry + ffn.dense(lp_c["mlp"], h, _fcfg(cfg))
        return carry, state

    def period_step(pp, x):
        states = {}
        for key, kind in zip("abc", PERIOD):
            x, states[key] = mix_prefill(kind, pp[key], x)
        return x, states

    _, remainder = _pattern(cfg)
    period_states = []
    for pp in unstack_layers(params["periods"]):
        x, states = remat(cfg, period_step, pp, x)
        period_states.append(states)
    tail_states = []
    for lp, kind in zip(params["tail"], remainder):
        x, st = mix_prefill(kind, lp, x)
        tail_states.append(st)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = logits_fn(cfg, params, x[:, -1:, :])
    return logits, {"periods": stack_layers(period_states), "tail": tail_states,
                    "pos": torch.tensor(S, dtype=torch.int32, device=x.device)}


def decode_step(cfg, params, tokens: torch.Tensor, cache):
    """One decode step for the whole stack.  tokens: (B, 1) int32."""
    x = embed_tokens(cfg, params, tokens)
    pos = cache["pos"]
    n_periods, remainder = _pattern(cfg)
    new_periods = []
    for l in range(n_periods):
        pp, pc = layer_slice(params["periods"], l), layer_slice(cache["periods"], l)
        new_pc = {}
        for key, kind in zip("abc", PERIOD):
            x, new_pc[key] = _mix_decode(cfg, kind, pp[key], x, pc[key], pos)
        new_periods.append(new_pc)
    new_tail = []
    for lp, lc, kind in zip(params["tail"], cache["tail"], remainder):
        x, lc = _mix_decode(cfg, kind, lp, x, lc, pos)
        new_tail.append(lc)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return logits_fn(cfg, params, x), {"periods": stack_layers(new_periods),
                                       "tail": new_tail, "pos": pos + 1}
