"""Feed-forward blocks: gated MLP (SwiGLU/GeGLU) and routed MoE.

MoE is the sort-based dropless-with-capacity router of the reference:
tokens are sorted by expert, gathered into an (E, C, D) dispatch buffer,
run through batched expert einsums, and combined with top-k gate weights.
Covers granite-moe (40e top-8) and deepseek-v3 (1 shared + 256 routed top-8
with sigmoid routing + bias-free norm-topk).

Routing order follows the reference exactly: top-k by a stable descending
sort (equal scores: the lower expert first, as ``lax.top_k``), a stable
argsort of the slots, Python's ``round`` for the capacity, and the K
combine gathers accumulated in the compute dtype in order ``j = 0..K-1``.
The reference's manual expert parallelism (``moe_manual_ep``) runs only
under a multi-device mesh and is not ported (ROADMAP queue 1 item 4).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .common import Builder, gelu_glu, shard, swiglu


@dataclasses.dataclass(frozen=True)
class FfnCfg:
    d_model: int
    d_ff: int
    act: str = "silu"          # 'silu' -> SwiGLU, 'gelu' -> GeGLU
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0          # shared (always-on) experts, deepseek-style
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_softmax: bool = True  # False -> sigmoid scores (deepseek-v3)


def _glu(act: str):
    return swiglu if act == "silu" else gelu_glu


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

def init_dense(b: Builder, cfg: FfnCfg, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "gate": b.param((d, f), ("embed_w", "mlp")),
        "up": b.param((d, f), ("embed_w", "mlp")),
        "down": b.param((f, d), ("mlp", "embed_w")),
    }


def dense(p, x: torch.Tensor, cfg: FfnCfg) -> torch.Tensor:
    h = _glu(cfg.act)(x @ p["gate"], x @ p["up"])
    h = shard(h, "batch", "seq", "mlp")
    return shard(h @ p["down"], "batch", "seq", "embed")


def init_plain(b: Builder, d_model: int, d_ff: int):
    """Ungated 2-layer MLP (whisper-style fc1 -> GELU -> fc2)."""
    return {
        "fc1": b.param((d_model, d_ff), ("embed_w", "mlp")),
        "fc2": b.param((d_ff, d_model), ("mlp", "embed_w")),
    }


def plain(p, x: torch.Tensor) -> torch.Tensor:
    h = F.gelu(x @ p["fc1"], approximate="tanh")
    h = shard(h, "batch", "seq", "mlp")
    return shard(h @ p["fc2"], "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# routed MoE
# ---------------------------------------------------------------------------

def init_moe(b: Builder, cfg: FfnCfg):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": b.param((d, e), ("embed_w", "experts")),
        "w_gate": b.param((e, d, f), ("experts", "embed_w", "mlp")),
        "w_up": b.param((e, d, f), ("experts", "embed_w", "mlp")),
        "w_down": b.param((e, f, d), ("experts", "mlp", "embed_w")),
    }
    if cfg.n_shared:
        p["shared"] = init_dense(b, cfg, d_ff=cfg.shared_d_ff or cfg.d_ff * cfg.n_shared)
    return p


def route(p, xt: torch.Tensor, cfg: FfnCfg) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, D) tokens -> renormalized top-k gate values (T, K), f32, and
    expert indices (T, K), int64, the lower index first among equal
    scores."""
    scores = (xt @ p["router"]).float()                    # (T, E)
    if cfg.router_softmax:
        probs = torch.softmax(scores, dim=-1)
    else:  # deepseek-v3 sigmoid routing with top-k renormalization
        probs = torch.sigmoid(scores)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[:, :cfg.top_k], idx[:, :cfg.top_k]
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    return gate_vals, expert_idx


def moe(p, x: torch.Tensor, cfg: FfnCfg) -> torch.Tensor:
    """Routed mixture with capacity; returns combined output (B, S, D)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    dev = x.device
    xt = shard(x.reshape(T, D), "batch", None)
    gate_vals, expert_idx = route(p, xt, cfg)

    # ---- routing plan in integer space (cheap: (T*K,) tensors) -------------
    slots_e = expert_idx.reshape(-1)                       # (T*K,)
    order = torch.argsort(slots_e, stable=True)
    sorted_e = slots_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    pos_in_e = torch.arange(T * K, device=dev) - starts[sorted_e]
    C = int(max(1, round(T * K / E * cfg.capacity_factor)))
    dest = torch.where(pos_in_e < C, sorted_e * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))   # drop -> row E*C
    src_token = order // K

    # ---- dispatch: ONE gather straight into the (E, C, D) buffer ----------
    slot_src = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev)
    slot_src[dest] = src_token                             # dropped -> row E*C
    slot_src = slot_src[:E * C]
    xt_pad = torch.cat([xt, torch.zeros((1, D), dtype=x.dtype, device=dev)])
    dispatch = shard(xt_pad[slot_src].reshape(E, C, D),
                     "experts", "expert_cap", None)

    # ---- expert compute ----------------------------------------------------
    h = _glu(cfg.act)(
        torch.einsum("ecd,edf->ecf", dispatch, p["w_gate"]),
        torch.einsum("ecd,edf->ecf", dispatch, p["w_up"]),
    )
    h = shard(h, "experts", "expert_cap", None)
    out_e = torch.einsum("ecf,efd->ecd", h, p["w_down"])    # (E, C, D)
    out_e = shard(out_e, "experts", "expert_cap", None).reshape(E * C, D)
    out_pad = torch.cat([out_e, torch.zeros((1, D), dtype=out_e.dtype, device=dev)])

    # ---- combine: K gathers in token order, weighted by gates --------------
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * K, device=dev)
    dest_tok = dest[inv].reshape(T, K)                     # row per (token, k)
    combined = torch.zeros((T, D), dtype=x.dtype, device=dev)
    for j in range(K):
        rows = out_pad[dest_tok[:, j]]                     # dropped -> zeros row
        combined = combined + shard(rows, "batch", None) * gate_vals[:, j:j + 1].to(x.dtype)
    combined = shard(combined, "batch", None)

    if cfg.n_shared:
        combined = combined + dense(p["shared"], xt[:, None, :], cfg)[:, 0, :]
    return shard(combined.reshape(B, S, D), "batch", "seq", "embed")


def init(b: Builder, cfg: FfnCfg):
    return init_moe(b, cfg) if cfg.moe else init_dense(b, cfg)


def forward(p, x: torch.Tensor, cfg: FfnCfg) -> torch.Tensor:
    return moe(p, x, cfg) if cfg.moe else dense(p, x, cfg)
