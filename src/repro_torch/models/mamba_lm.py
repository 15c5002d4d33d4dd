"""Falcon-Mamba-style attention-free LM (mamba-1 blocks, no MLP).

64 identical blocks: ``x += mamba(rms_norm(x))``; pure SSM (d_ff = 0 in the
assignment spec).  Decode carries (conv, ssm) states — O(1) per token.
Every layer step casts its f32 master weights to the compute dtype, as the
reference's scan body does, and runs under ``cfg.remat`` (``common.remat``).
"""
from __future__ import annotations

import torch

from . import ssm
from .common import (Builder, cast_tree, layer_slice, remat, resolve_device,
                     rms_norm, shard, stack_layers, stacked_spec, tree_map,
                     unstack_layers)
from .transformer import logits_fn, token_loss


def _mcfg(cfg) -> ssm.MambaCfg:
    return ssm.MambaCfg(d_model=cfg.d_model, d_state=cfg.ssm_state,
                        d_conv=cfg.d_conv, expand=cfg.expand)


def init(cfg, generator: torch.Generator | None, device="cuda"):
    """Returns (params, logical-spec tree).  ``generator=None`` gives
    ``meta`` tensors of the concrete shapes and dtypes."""
    b = Builder(generator, dtype=cfg.param_dtype,
                device="meta" if generator is None else resolve_device(device))
    mcfg = _mcfg(cfg)

    def one_layer():
        return {"ln": b.param((cfg.d_model,), ("embed",), init="zeros"),
                "mixer": ssm.init_mamba(b, mcfg)}

    layers = [one_layer() for _ in range(cfg.n_layers)]
    vals = [Builder.split(l)[0] for l in layers]
    spec = stacked_spec(Builder.split(layers[0])[1])
    tree = {
        "embed": b.param((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                         scale=1.0 / cfg.d_model ** 0.5),
        "ln_f": b.param((cfg.d_model,), ("embed",), init="zeros"),
        "lm_head": b.param((cfg.d_model, cfg.vocab), ("embed_w", "vocab")),
    }
    params, specs = Builder.split(tree)
    params["layers"] = stack_layers(vals)
    specs["layers"] = spec
    return params, specs


def _embed(cfg, params, tokens):
    x = params["embed"].to(cfg.compute_dtype)[tokens]
    return shard(x, "batch", "seq", "embed")


def hidden_states(cfg, params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
    x = _embed(cfg, params, batch["tokens"])
    mcfg = _mcfg(cfg)

    def step(lp, x):
        lp = cast_tree(lp, cfg.compute_dtype)
        h = rms_norm(x, lp["ln"], cfg.norm_eps)
        return x + ssm.mamba(lp["mixer"], h, mcfg)

    for lp in unstack_layers(params["layers"]):
        x = remat(cfg, step, lp, x)
    return rms_norm(x, params["ln_f"], cfg.norm_eps)


def full_logits(cfg, params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
    return logits_fn(cfg, params, hidden_states(cfg, params, batch)).float()


def loss_fn(cfg, params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
    return token_loss(cfg, params, hidden_states(cfg, params, batch),
                      batch["tokens"])


def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    """State cache is O(1) in context length — max_len unused by design."""
    device = resolve_device(device)
    one = ssm.mamba_state(_mcfg(cfg), batch, device=device)
    layers = tree_map(lambda l: l[None].repeat((cfg.n_layers,) + (1,) * l.ndim),
                      one)
    return {"layers": layers,
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def cache_specs(cfg, batch: int, max_len: int):
    return tree_map(
        lambda l: ("layers", "batch", "mlp") if l.ndim == 3
        else (("layers", "batch", None, "mlp") if l.ndim == 4 else
              tuple(None for _ in l.shape)),
        init_cache(cfg, batch, max_len, device="meta"))


def decode_step(cfg, params, tokens: torch.Tensor, cache):
    """One decode step for the whole stack.  tokens: (B, 1) int32."""
    x = _embed(cfg, params, tokens)
    mcfg = _mcfg(cfg)
    new_layers = []
    for l in range(cfg.n_layers):
        lp = cast_tree(layer_slice(params["layers"], l), cfg.compute_dtype)
        h = rms_norm(x, lp["ln"], cfg.norm_eps)
        h, lc = ssm.mamba_decode(lp["mixer"], h, mcfg,
                                 layer_slice(cache["layers"], l))
        x = x + h
        new_layers.append(lc)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return logits_fn(cfg, params, x), {"layers": stack_layers(new_layers),
                                       "pos": cache["pos"] + 1}


def prefill(cfg, params, batch: dict[str, torch.Tensor], max_len: int):
    """Run the sequence through, carrying final states into the cache (the
    conv state cast back to bf16)."""
    x = _embed(cfg, params, batch["tokens"])
    mcfg = _mcfg(cfg)
    S = x.shape[1]

    def step(lp, x):
        lp = cast_tree(lp, cfg.compute_dtype)
        h = rms_norm(x, lp["ln"], cfg.norm_eps)
        xz = h @ lp["mixer"]["in_proj"]
        y, conv_s, ssm_s = ssm._mamba_core(lp["mixer"], xz, mcfg, None, None)
        return x + y, {"conv": conv_s.to(torch.bfloat16), "ssm": ssm_s}

    states = []
    for lp in unstack_layers(params["layers"]):
        x, state = remat(cfg, step, lp, x)
        states.append(state)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = logits_fn(cfg, params, x[:, -1:, :])
    return logits, {"layers": stack_layers(states),
                    "pos": torch.tensor(S, dtype=torch.int32, device=x.device)}
