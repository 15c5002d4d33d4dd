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
Under an active mesh with a ``model`` axis larger than 1, :func:`forward`
takes manual expert parallelism (:func:`moe_manual_ep`), as the
reference's does.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..comm import exchange
from .common import CTX, Builder, gelu_glu, shard, swiglu


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


# ---------------------------------------------------------------------------
# manual expert parallelism (peer lists + explicit all_to_all)
# ---------------------------------------------------------------------------

def _dp_axes():
    rule = CTX.rules.get("batch")
    return rule if isinstance(rule, tuple) else (rule,)


def _can_manual_ep(cfg: FfnCfg, x: torch.Tensor) -> bool:
    """Manual EP needs a ``model`` axis > 1 and tokens to split over dp x tp."""
    if CTX.mesh is None or "model" not in CTX.mesh.axis_names:
        return False
    if CTX.manual_dp:
        return False  # already inside a manual-DP worker: no nesting
    tp = CTX.mesh.shape["model"]
    dp = 1
    for a in _dp_axes():
        if a not in CTX.mesh.axis_names:
            return False
        dp *= CTX.mesh.shape[a]
    B, S, _ = x.shape
    T = B * S
    if tp <= 1 or B % dp or (T // dp) % tp:
        return False
    return (T // dp // tp) * cfg.top_k >= tp  # at least one slot per peer


def _dropping_set(n: int, index: torch.Tensor, values: torch.Tensor,
                  fill: int) -> torch.Tensor:
    """``jnp.full((n + 1,), fill).at[index].set(values, mode="drop")[:n]``
    for indices in ``[0, n]``: index ``n`` (the overflow row) is written
    into a buffer one longer and sliced off."""
    out = torch.full((n + 1,), fill, dtype=torch.int64, device=index.device)
    out[index] = values
    return out[:n]


@dataclasses.dataclass
class _Plan:
    """One peer's stage-1 routing of its ``Ts`` tokens."""

    gate_vals: torch.Tensor     # (Ts, K) f32
    order1: torch.Tensor        # (Ts*K,) slots sorted by destination peer
    slot1: torch.Tensor         # (Ts*K,) send row, tp*cap1 = dropped
    send_rows: torch.Tensor     # (tp*cap1, D)
    send_le: torch.Tensor       # (tp*cap1,) local expert id, E_loc = empty


def _route_peer(xs, router, cfg: FfnCfg, tp: int, E_loc: int,
                cap1: int) -> _Plan:
    """Stage 1 on one peer: top-k, then its token-slots sorted to the
    destination peers' send rows (at most ``cap1`` each)."""
    Ts, D = xs.shape
    K = cfg.top_k
    dev = xs.device
    gate_vals, expert_idx = route({"router": router}, xs, cfg)   # (Ts, K)
    flat_e = expert_idx.reshape(-1)                              # (Ts*K,)
    dest_g = flat_e // E_loc
    order1 = torch.argsort(dest_g, stable=True)
    sorted_g = dest_g[order1]
    starts = torch.searchsorted(sorted_g, torch.arange(tp, device=dev))
    pos1 = torch.arange(Ts * K, device=dev) - starts[sorted_g]
    slot1 = torch.where(pos1 < cap1, sorted_g * cap1 + pos1,
                        torch.full_like(pos1, tp * cap1))
    # send buffers: rows + local-expert ids (E_loc marks an empty slot)
    send_src = _dropping_set(tp * cap1, slot1, order1 // K, Ts)
    xs_pad = torch.cat([xs, torch.zeros((1, D), dtype=xs.dtype, device=dev)])
    send_rows = xs_pad[send_src]                                 # (tp*cap1, D)
    send_le = _dropping_set(tp * cap1, slot1, flat_e[order1] % E_loc, E_loc)
    send_le = torch.where(send_src == Ts, torch.full_like(send_le, E_loc),
                          send_le)
    return _Plan(gate_vals, order1, slot1, send_rows, send_le)


def _dispatch_slots(recv_le: torch.Tensor, E_loc: int,
                    cap2: int) -> torch.Tensor:
    """Stage 2's plan on one peer: each received row's slot in the
    ``(E_loc, cap2)`` dispatch buffer, ``E_loc * cap2`` for empties and
    drops (empties sort last)."""
    R = recv_le.shape[0]
    dev = recv_le.device
    order2 = torch.argsort(recv_le, stable=True)
    sorted_le = recv_le[order2]
    starts2 = torch.searchsorted(sorted_le, torch.arange(E_loc, device=dev))
    pos2 = (torch.arange(R, device=dev)
            - starts2[torch.clamp(sorted_le, 0, E_loc - 1)])
    slot2_sorted = torch.where((sorted_le < E_loc) & (pos2 < cap2),
                               sorted_le * cap2 + pos2,
                               torch.full_like(pos2, E_loc * cap2))
    slot2 = torch.zeros((R,), dtype=torch.int64, device=dev)
    slot2[order2] = slot2_sorted
    return slot2


def _experts_peer(recv_rows, recv_le, w_gate, w_up, w_down, cfg: FfnCfg,
                  E_loc: int, cap2: int) -> torch.Tensor:
    """Stage 2 on one peer: dispatch the received rows to its ``E_loc``
    experts, run them, and return each received row's output (R, D) in
    receive order (zeros for empties and drops)."""
    R, D = recv_rows.shape
    dev = recv_rows.device
    slot2 = _dispatch_slots(recv_le, E_loc, cap2)
    disp_src = _dropping_set(E_loc * cap2, slot2,
                             torch.arange(R, device=dev), R)
    recv_pad = torch.cat([recv_rows, torch.zeros((1, D), dtype=recv_rows.dtype,
                                                  device=dev)])
    disp = recv_pad[disp_src].reshape(E_loc, cap2, D)
    h = _glu(cfg.act)(
        torch.einsum("ecd,edf->ecf", disp, w_gate),
        torch.einsum("ecd,edf->ecf", disp, w_up),
    )
    out_e = torch.einsum("ecf,efd->ecd", h, w_down).reshape(E_loc * cap2, D)
    out_pad = torch.cat([out_e, torch.zeros((1, D), dtype=out_e.dtype,
                                            device=dev)])
    return out_pad[slot2]                                        # (R, D)


def _combine_peer(plan: _Plan, y_back, dtype: torch.dtype) -> torch.Tensor:
    """The return path on one peer: the K gates of each of its tokens in
    order ``j = 0..K-1`` over the rows sent back (a dropped slot reads the
    zero row past them)."""
    Ts, K = plan.gate_vals.shape
    D = y_back.shape[1]
    dev = y_back.device
    y_back = torch.cat([y_back, torch.zeros((1, D), dtype=y_back.dtype,
                                            device=dev)])
    slot1_tok = torch.zeros((Ts * K,), dtype=torch.int64, device=dev)
    slot1_tok[plan.order1] = plan.slot1
    slot1_tok = slot1_tok.reshape(Ts, K)
    acc = torch.zeros((Ts, D), dtype=dtype, device=dev)
    for j in range(K):
        acc = acc + y_back[slot1_tok[:, j]] * plan.gate_vals[:, j:j + 1].to(dtype)
    return acc


def moe_manual_ep(p, x: torch.Tensor, cfg: FfnCfg) -> torch.Tensor:
    """Routed MoE with explicit expert parallelism over the active mesh's
    ``model`` axis (the reference's ``shard_map`` body, run per peer).

    The mesh's devices, in row-major order, form ``dp`` groups (the batch
    axes) of ``tp`` peers (the ``model`` axis).  Group ``d`` takes batch
    rows ``[d*B/dp, (d+1)*B/dp)``; its peer ``g`` routes the token slice
    ``[g*Ts, (g+1)*Ts)`` of them (``Ts = T_loc / tp``) and holds experts
    ``[g*E_loc, (g+1)*E_loc)``.  Stage 1: each peer sorts its token-slots
    to the peers that hold their experts (at most ``cap1`` per peer) and
    :func:`~repro_torch.comm.exchange.all_to_all` sends the rows and their
    local expert ids.  Stage 2: each peer dispatches what it received to
    its ``E_loc`` experts (at most ``cap2`` each), runs the three expert
    einsums and sends the outputs back through the reverse all-to-all; the
    sender combines its K gates in order and the group's peers all-gather
    the full local token set.  Experts that do not divide over ``tp`` are
    padded with dead experts (zero weights, never routed to): granite-moe's
    40 on tp 16.  The router and every expert weight are cast to
    ``x.dtype`` first, as the reference casts them (``moe`` does not).
    The shared experts run on the whole ``x`` outside the peers.

    ``x`` lies on one device; each peer's tensors move to its device and
    the result comes back to ``x``'s.  On ``meta`` devices under
    ``exchange.symmetric_peers()`` (the dry run) one peer of each group
    runs and stands for all of them.
    """
    mesh = CTX.mesh
    tp = mesh.shape["model"]
    dp_axes = tuple(a for a in _dp_axes() if a in mesh.axis_names)
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    E_pad = -(-E // tp) * tp
    E_loc = E_pad // tp
    cf = cfg.capacity_factor
    groups = mesh.grid(dp_axes)                        # (dp, tp) devices
    dp = len(groups)
    Bl = B // dp
    T_loc = Bl * S
    Ts = T_loc // tp
    cap1 = int(max(1, round(Ts * K / tp * cf)))
    R = tp * cap1
    cap2 = int(max(1, round(R / E_loc * cf)))

    def pad_e(w):
        w = w.to(x.dtype)
        if E_pad == E:
            return w
        return torch.cat([w, torch.zeros((E_pad - E,) + tuple(w.shape[1:]),
                                         dtype=w.dtype, device=w.device)])

    router = p["router"].to(x.dtype)
    w_gate, w_up, w_down = (pad_e(p[k]) for k in ("w_gate", "w_up", "w_down"))

    outs = []
    for d, devs in enumerate(groups):
        xt = x[d * Bl:(d + 1) * Bl].reshape(T_loc, D)
        peers = list(range(tp))
        plans = exchange.map_peers(
            lambda g, dev: _route_peer(xt[g * Ts:(g + 1) * Ts].to(dev),
                                       router.to(dev), cfg, tp, E_loc, cap1),
            peers, devs)
        recv_rows = exchange.all_to_all([pl.send_rows for pl in plans])
        recv_le = exchange.all_to_all([pl.send_le for pl in plans])
        local = lambda w, g, dev: w[g * E_loc:(g + 1) * E_loc].to(dev)
        y_rows = exchange.map_peers(
            lambda g, dev, rows, le: _experts_peer(
                rows, le, local(w_gate, g, dev), local(w_up, g, dev),
                local(w_down, g, dev), cfg, E_loc, cap2),
            peers, devs, recv_rows, recv_le)
        y_back = exchange.all_to_all(y_rows)
        acc = exchange.map_peers(
            lambda pl, yb: _combine_peer(pl, yb, x.dtype),
            plans, y_back)
        # reassemble the group's token set from its tp routing peers
        y_full = exchange.all_gather(acc)                        # (T_loc, D)
        outs.append(y_full[0].to(x.device).reshape(Bl, S, D))
    out = outs[0] if dp == 1 else torch.cat(outs)
    if cfg.n_shared:
        out = out + dense(p["shared"], x, cfg)
    return shard(out, "batch", "seq", "embed")


def init(b: Builder, cfg: FfnCfg):
    return init_moe(b, cfg) if cfg.moe else init_dense(b, cfg)


def forward(p, x: torch.Tensor, cfg: FfnCfg) -> torch.Tensor:
    if not cfg.moe:
        return dense(p, x, cfg)
    if _can_manual_ep(cfg, x):
        return moe_manual_ep(p, x, cfg)
    return moe(p, x, cfg)
