"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

The conv frontend is a STUB, as in the reference: ``input_specs()`` provides
precomputed frame embeddings (B, n_frames, d_model) — the backbone is the
deliverable.  Encoder: bidirectional self-attention; decoder: causal
self-attention + cross-attention.  Sinusoidal positions (whisper uses
absolute positions, not RoPE).

Serving keeps the reference's behaviour: ``zoo``'s prefill returns a fresh
:func:`init_cache` (no self K/V, zero cross K/V, position 0), and the
``Engine`` never fills the cross cache, so served tokens attend to zero
cross K/V.  :func:`cross_cache` builds the cross K/V from an encoder output
for callers that want them (the parity checks).
"""
from __future__ import annotations

import dataclasses

import torch

from . import attention, ffn
from .common import (Builder, cast_tree, layer_slice, remat, resolve_device,
                     rms_norm, shard, sinusoidal_positions, stack_layers,
                     stacked_spec, tree_map, unstack_layers)
from .transformer import LONG_PREFILL, logits_fn, seq_positions, token_loss


def _acfg(cfg) -> attention.AttnCfg:
    return attention.AttnCfg(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.head_dim, use_rope=False, kv_quant=cfg.kv_quant)


def init(cfg, generator: torch.Generator | None, device="cuda"):
    """Returns (params, logical-spec tree).  ``generator=None`` gives
    ``meta`` tensors of the concrete shapes and dtypes."""
    b = Builder(generator, dtype=cfg.param_dtype,
                device="meta" if generator is None else resolve_device(device))
    acfg = _acfg(cfg)

    def enc_layer():
        return {"ln1": b.param((cfg.d_model,), ("embed",), init="zeros"),
                "attn": attention.init(b, acfg),
                "ln2": b.param((cfg.d_model,), ("embed",), init="zeros"),
                "mlp": ffn.init_plain(b, cfg.d_model, cfg.d_ff)}

    def dec_layer():
        return {"ln1": b.param((cfg.d_model,), ("embed",), init="zeros"),
                "attn": attention.init(b, acfg),
                "ln_x": b.param((cfg.d_model,), ("embed",), init="zeros"),
                "xattn": attention.init(b, acfg),
                "ln2": b.param((cfg.d_model,), ("embed",), init="zeros"),
                "mlp": ffn.init_plain(b, cfg.d_model, cfg.d_ff)}

    enc = [enc_layer() for _ in range(cfg.enc_layers)]
    dec = [dec_layer() for _ in range(cfg.n_layers)]
    tree = {
        "embed": b.param((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                         scale=1.0 / cfg.d_model ** 0.5),
        "ln_enc": b.param((cfg.d_model,), ("embed",), init="zeros"),
        "ln_f": b.param((cfg.d_model,), ("embed",), init="zeros"),
        "lm_head": b.param((cfg.d_model, cfg.vocab), ("embed_w", "vocab")),
    }
    params, specs = Builder.split(tree)
    params["enc"] = stack_layers([Builder.split(l)[0] for l in enc])
    specs["enc"] = stacked_spec(Builder.split(enc[0])[1])
    params["dec"] = stack_layers([Builder.split(l)[0] for l in dec])
    specs["dec"] = stacked_spec(Builder.split(dec[0])[1])
    return params, specs


def encode(cfg, params, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, F, d_model) stub embeddings -> encoder output."""
    acfg = _acfg(cfg)
    B, F, _ = frames.shape
    dt = cfg.compute_dtype
    x = frames.to(dt) + sinusoidal_positions(F, cfg.d_model,
                                             device=frames.device).to(dt)
    x = shard(x, "batch", "seq", "embed")
    positions = seq_positions(B, F, frames.device)
    bidir = dataclasses.replace(acfg, causal=False)

    def step(lp, x):
        lp = cast_tree(lp, dt)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + attention.forward(lp["attn"], h, bidir, positions)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + ffn.plain(lp["mlp"], h)

    for lp in unstack_layers(params["enc"]):
        x = remat(cfg, step, lp, x)
    return rms_norm(x, params["ln_enc"], cfg.norm_eps)


def _dec_embed(cfg, params, tokens, pos0=0):
    B, S = tokens.shape
    x = params["embed"].to(cfg.compute_dtype)[tokens]
    pe = sinusoidal_positions(pos0 + S, cfg.d_model,
                              device=tokens.device)[pos0:].to(cfg.compute_dtype)
    return shard(x + pe, "batch", "seq", "embed")


def decode_train(cfg, params, tokens: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    acfg = _acfg(cfg)
    B, S = tokens.shape
    x = _dec_embed(cfg, params, tokens)
    positions = seq_positions(B, S, tokens.device)

    def step(lp, x):
        lp = cast_tree(lp, cfg.compute_dtype)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if S > LONG_PREFILL:
            x = x + attention.forward_chunked(lp["attn"], h, acfg, positions)
        else:
            x = x + attention.forward(lp["attn"], h, acfg, positions)
        h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
        x = x + attention.cross_forward(lp["xattn"], h, enc_out, acfg)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + ffn.plain(lp["mlp"], h)

    for lp in unstack_layers(params["dec"]):
        x = remat(cfg, step, lp, x)
    return rms_norm(x, params["ln_f"], cfg.norm_eps)


def _decoded(cfg, params, batch):
    enc_out = encode(cfg, params, batch["frames"])
    return decode_train(cfg, params, batch["tokens"], enc_out)


def full_logits(cfg, params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
    return logits_fn(cfg, params, _decoded(cfg, params, batch)).float()


def loss_fn(cfg, params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
    return token_loss(cfg, params, _decoded(cfg, params, batch),
                      batch["tokens"])


# ---------------------------------------------------------------------------
# serving: decoder self cache + precomputed cross KV
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    device = resolve_device(device)
    acfg = _acfg(cfg)
    self_c = attention.init_cache(acfg, batch, max_len,
                                  dtype=cfg.compute_dtype, device=device)
    shape = (batch, cfg.enc_frames, cfg.n_kv, cfg.head_dim)
    cross = {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}
    one = {"self": self_c, "cross": cross}
    layers = tree_map(lambda l: l[None].repeat((cfg.n_layers,) + (1,) * l.ndim),
                      one)
    return {"layers": layers,
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def cache_specs(cfg, batch: int, max_len: int):
    return tree_map(
        lambda l: ("layers", "batch", "kv_seq", "kv_heads", None) if l.ndim == 5
        else tuple(None for _ in l.shape),
        init_cache(cfg, batch, max_len, device="meta"))


def cross_cache(cfg, params, enc_out: torch.Tensor) -> dict[str, torch.Tensor]:
    """Every decoder layer's cross K/V of ``enc_out``, stacked on the layers
    axis in the compute dtype: what ``cache["layers"]["cross"]`` holds once
    it is filled from the encoder.  The projection runs in f32 on the
    master weights, then rounds to the compute dtype."""
    acfg = _acfg(cfg)
    positions = torch.zeros(enc_out.shape[:2], dtype=torch.int32,
                            device=enc_out.device)
    kvs = [attention.project_kv(
               cast_tree(layer_slice(params["dec"], l)["xattn"], torch.float32),
               enc_out.float(), acfg, positions)
           for l in range(cfg.n_layers)]
    return {n: torch.stack([kv[n] for kv in kvs]).to(cfg.compute_dtype)
            for n in ("k", "v")}


def decode_step(cfg, params, tokens: torch.Tensor, cache):
    """One decode step for the whole decoder.  tokens: (B, 1) int32.  The
    position row is taken at ``pos`` clamped to ``max_len - 1`` on the
    device, as the reference's ``dynamic_slice_in_dim`` clamps."""
    acfg = _acfg(cfg)
    pos = cache["pos"]
    max_len = cache["layers"]["self"]["k"].shape[2]
    pe = sinusoidal_positions(max_len, cfg.d_model, device=tokens.device)
    row = torch.clamp(pos, 0, max_len - 1).reshape(1).long()
    x = (params["embed"].to(cfg.compute_dtype)[tokens]
         + pe.index_select(0, row)[None].to(cfg.compute_dtype))
    B = tokens.shape[0]
    new_self = []
    for l in range(cfg.n_layers):
        lp = cast_tree(layer_slice(params["dec"], l), cfg.compute_dtype)
        lc = layer_slice(cache["layers"], l)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        h, self_c = attention.decode_step(lp["attn"], h, acfg, lc["self"], pos)
        x = x + h
        h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
        q = (h @ lp["xattn"]["wq"]).reshape(B, 1, cfg.n_heads, cfg.head_dim)
        ctx = attention.sdpa(q, lc["cross"]["k"].to(h.dtype),
                             lc["cross"]["v"].to(h.dtype), None,
                             1.0 / cfg.head_dim ** 0.5)
        ctx = ctx.reshape(B, 1, cfg.n_heads * cfg.head_dim)
        x = x + ctx @ lp["xattn"]["wo"]
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + ffn.plain(lp["mlp"], h)
        new_self.append(self_c)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    # the cross K/V pass through unchanged (no per-step copy of them)
    layers = {"self": stack_layers(new_self), "cross": cache["layers"]["cross"]}
    return logits_fn(cfg, params, x), {"layers": layers, "pos": pos + 1}
