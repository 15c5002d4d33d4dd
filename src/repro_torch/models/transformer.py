"""Config-driven decoder-only transformer LM.

One assembly covers seven architectures: qwen3-4b (GQA+qk-norm),
granite-3-2b, smollm-360m, minitron-4b (dense GQA), granite-moe-3b (routed
MoE), deepseek-v3-671b (MLA + first-k-dense + shared-expert MoE), and the
paligemma-3b decoder (MQA + prefix embeds).  Layers are *grouped* by kind;
each group's params are stacked on a leading ``layers`` axis and the
forward passes loop over it.  Every layer step casts its f32 master
weights to the compute dtype, as the reference's scan body does, and runs
under ``cfg.remat`` (``common.remat``).
"""
from __future__ import annotations

import torch

from . import attention, ffn
from .common import (Builder, cast_tree, layer_slice, remat, resolve_device,
                     rms_norm, shard, stack_layers, stacked_spec, tree_map,
                     unstack_layers)

LONG_PREFILL = 2048  # query-chunk attention above this (bounds the logits)


def _attn_cfg(cfg) -> attention.AttnCfg:
    return attention.AttnCfg(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.head_dim, qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        mla=cfg.mla, q_lora=cfg.q_lora, kv_lora=cfg.kv_lora,
        qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope, v_dim=cfg.v_head,
        kv_quant=cfg.kv_quant,
    )


def _ffn_cfg(cfg, kind: str) -> ffn.FfnCfg:
    if kind == "moe":
        return ffn.FfnCfg(
            d_model=cfg.d_model, d_ff=cfg.moe_d_ff or cfg.d_ff, act=cfg.act,
            moe=True, n_experts=cfg.n_experts, top_k=cfg.top_k,
            n_shared=cfg.n_shared, shared_d_ff=(cfg.moe_d_ff or cfg.d_ff) * max(cfg.n_shared, 1),
            router_softmax=cfg.router_softmax, capacity_factor=cfg.capacity_factor,
        )
    return ffn.FfnCfg(d_model=cfg.d_model, d_ff=cfg.d_ff, act=cfg.act)


def layer_groups(cfg) -> list[tuple[int, str]]:
    """[(n_layers, 'dense'|'moe')] — deepseek-style first-k-dense supported."""
    if cfg.moe:
        k = cfg.first_k_dense
        groups = []
        if k:
            groups.append((k, "dense"))
        groups.append((cfg.n_layers - k, "moe"))
        return groups
    return [(cfg.n_layers, "dense")]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(cfg, generator: torch.Generator | None, device="cuda"):
    """Returns (params, logical-spec tree).  ``generator=None`` gives
    ``meta`` tensors of the concrete shapes and dtypes."""
    b = Builder(generator, dtype=cfg.param_dtype,
                device="meta" if generator is None else resolve_device(device))
    acfg = _attn_cfg(cfg)

    def one_layer(kind: str):
        return {
            "ln1": b.param((cfg.d_model,), ("embed",), init="zeros"),
            "attn": attention.init(b, acfg),
            "ln2": b.param((cfg.d_model,), ("embed",), init="zeros"),
            "ffn": ffn.init(b, _ffn_cfg(cfg, kind)),
        }

    groups_p, groups_s = [], []
    for count, kind in layer_groups(cfg):
        layers = [one_layer(kind) for _ in range(count)]
        vals = [Builder.split(l)[0] for l in layers]
        spec = Builder.split(layers[0])[1]
        groups_p.append(stack_layers(vals))
        groups_s.append(stacked_spec(spec))

    tree = {
        "embed": b.param((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                         scale=1.0 / cfg.d_model ** 0.5),
        "ln_f": b.param((cfg.d_model,), ("embed",), init="zeros"),
        "lm_head": b.param((cfg.d_model, cfg.vocab), ("embed_w", "vocab")),
    }
    params, specs = Builder.split(tree)
    params["groups"] = groups_p
    specs["groups"] = groups_s
    return params, specs


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer_forward(cfg, kind: str, lp, x, positions, long_seq: bool):
    lp = cast_tree(lp, cfg.compute_dtype)
    acfg = _attn_cfg(cfg)
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if long_seq:
        h = attention.forward_chunked(lp["attn"], h, acfg, positions)
    else:
        h = attention.forward(lp["attn"], h, acfg, positions)
    x = x + h
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + ffn.forward(lp["ffn"], h, _ffn_cfg(cfg, kind))


def _run_groups(cfg, params, x, positions, *, long_seq: bool):
    for (_, kind), gp in zip(layer_groups(cfg), params["groups"]):
        if cfg.fsdp_bf16_gather:
            gp = cast_tree(gp, cfg.compute_dtype)
        for lp in unstack_layers(gp):
            x = remat(cfg, _layer_forward, cfg, kind, lp, x, positions,
                      long_seq, dots_policy=True)
    return x


def embed_tokens(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"].to(cfg.compute_dtype)[tokens]
    # the scale is rounded to the compute dtype first (sqrt(960) -> 31.0 in
    # bf16), as the reference's jnp.asarray(d_model ** 0.5, compute_dtype);
    # a host tensor, so no copy to the device
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.compute_dtype).item()
    return shard(x, "batch", "seq", "embed")


def seq_positions(B: int, S: int, device) -> torch.Tensor:
    """Positions 0..S-1 for each of B rows, int32."""
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def hidden_states(cfg, params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """Token (+ optional prefix) embedding -> final hidden states."""
    x = embed_tokens(cfg, params, batch["tokens"])
    if cfg.prefix_tokens:
        # VLM stub frontend: precomputed patch embeddings
        prefix = batch["prefix_embeds"].to(cfg.compute_dtype)
        x = torch.cat([prefix, x], dim=1)
    B, S, _ = x.shape
    x = _run_groups(cfg, params, x, seq_positions(B, S, x.device),
                    long_seq=S > LONG_PREFILL)
    return rms_norm(x, params["ln_f"], cfg.norm_eps)


def logits_fn(cfg, params, x: torch.Tensor) -> torch.Tensor:
    logits = x @ params["lm_head"].to(cfg.compute_dtype)
    return shard(logits, "batch", "seq", "vocab")


def full_logits(cfg, params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """Logits at every (text) position — decode-parity tests/serving."""
    x = hidden_states(cfg, params, batch)
    if cfg.prefix_tokens:
        x = x[:, cfg.prefix_tokens:, :]
    return logits_fn(cfg, params, x).float()


def loss_fn(cfg, params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token cross entropy (mean over tokens)."""
    x = hidden_states(cfg, params, batch)
    if cfg.prefix_tokens:
        x = x[:, cfg.prefix_tokens:, :]  # loss only on text positions
    return token_loss(cfg, params, x, batch["tokens"])


def token_loss(cfg, params, x: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy of final hidden states ``x`` (B, S, D)
    against ``tokens`` (B, S), in f32."""
    logits = logits_fn(cfg, params, x[:, :-1, :]).float()
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.mean(logz - gold)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    """Per-group stacked KV caches (+ scalar position)."""
    acfg = _attn_cfg(cfg)
    device = resolve_device(device)
    caches = []
    for count, _ in layer_groups(cfg):
        one = attention.init_cache(acfg, batch, max_len,
                                   dtype=cfg.compute_dtype, device=device)
        caches.append(tree_map(
            lambda l, _c=count: l[None].repeat((_c,) + (1,) * l.ndim), one))
    return {"layers": caches,
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def cache_specs(cfg, batch: int, max_len: int):
    """Logical sharding specs matching init_cache output."""
    def spec_of(leaf):
        if leaf.ndim >= 4:   # (L, B, S, kv, hd)
            return ("layers", "batch", "kv_seq", "kv_heads", None)
        if leaf.ndim == 3:   # (L, B, S) scales or latent w/o head dim
            return ("layers", "batch", "kv_seq")
        return tuple(None for _ in leaf.shape)
    return tree_map(spec_of, init_cache(cfg, batch, max_len, device="meta"))


def decode_step(cfg, params, tokens: torch.Tensor, cache):
    """One decode step for the whole stack.  tokens: (B, 1) int32."""
    acfg = _attn_cfg(cfg)
    x = embed_tokens(cfg, params, tokens)
    pos = cache["pos"]
    new_layers = []
    for (count, kind), gp, gc in zip(layer_groups(cfg), params["groups"],
                                     cache["layers"]):
        fcfg = _ffn_cfg(cfg, kind)
        new_gc = []
        for l in range(count):
            lp = cast_tree(layer_slice(gp, l), cfg.compute_dtype)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            h, lc = attention.decode_step(lp["attn"], h, acfg,
                                          layer_slice(gc, l), pos)
            x = x + h
            h = rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + ffn.forward(lp["ffn"], h, fcfg)
            new_gc.append(lc)
        new_layers.append(stack_layers(new_gc))
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = logits_fn(cfg, params, x)
    return logits, {"layers": new_layers, "pos": pos + 1}


def prefill(cfg, params, batch: dict[str, torch.Tensor], max_len: int):
    """Full-sequence forward that also builds the decode cache.

    Returns (last-position logits, cache).  KV entries are produced by a
    second projection of each layer's normed input (prefill is
    compute-dominated by the main pass; the extra projections are
    O(S·D·kv·hd)).  The cache holds the compute dtype, also under
    ``kv_quant``, as the reference's does.
    """
    acfg = _attn_cfg(cfg)
    x = embed_tokens(cfg, params, batch["tokens"])
    if cfg.prefix_tokens:
        prefix = batch["prefix_embeds"].to(cfg.compute_dtype)
        x = torch.cat([prefix, x], dim=1)
    B, S, _ = x.shape
    positions = seq_positions(B, S, x.device)
    long_seq = S > LONG_PREFILL

    def step(kind, lp, x):
        lp = cast_tree(lp, cfg.compute_dtype)
        kv_in = rms_norm(x, lp["ln1"], cfg.norm_eps)
        kv = attention.project_kv(lp["attn"], kv_in, acfg, positions)
        return _layer_forward(cfg, kind, lp, x, positions, long_seq), kv

    caches = []
    for (_, kind), gp in zip(layer_groups(cfg), params["groups"]):
        kvs = []
        for lp in unstack_layers(gp):
            x, kv = remat(cfg, step, kind, lp, x)
            kvs.append(kv)
        pad = max_len - S
        caches.append(tree_map(      # leaves (L, B, S, ...) -> (L, B, max_len, ...)
            lambda l: torch.nn.functional.pad(l, (0, 0) * (l.ndim - 3) + (0, pad)),
            stack_layers(kvs)))
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = logits_fn(cfg, params, x[:, -1:, :])
    return logits, {"layers": caches,
                    "pos": torch.tensor(S, dtype=torch.int32, device=x.device)}
