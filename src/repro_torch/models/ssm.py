"""State-space blocks: Mamba-1 selective scan and RG-LRU (RecurrentGemma).

Both recurrences are evaluated with a *chunked scan*: the sequence is split
into chunks; within a chunk the linear recurrence ``h_t = a_t h_{t-1} + b_t``
runs as a log-depth (Hillis–Steele) scan over the chunk axis, and a Python
loop carries the state across chunks.  The carry is applied after the
in-chunk scan (``h_all = acc_a * h + acc_b``), as the reference's
``associative_scan`` + ``lax.scan`` do; the roundings differ from XLA's
odd/even recursion only in the order of the f32 products.  The scan
workspace is one chunk: the ``(B, chunk, d_inner, state)`` Mamba terms are
never built at full sequence length.

Decode paths carry (conv_state, ssm_state) explicitly: O(1) per token.  The
conv state is held in bf16 by ``mamba_state`` / ``rglru_state``;
:func:`causal_conv1d` reads it in the compute dtype and returns the new one
in that dtype, as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from .common import Builder, shard

CHUNK = 256


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, self.d_model // 16)


@dataclasses.dataclass(frozen=True)
class RGLRUCfg:
    d_model: int
    lru_width: int
    d_conv: int = 4
    c: float = 8.0  # RG-LRU forget-rate temperature


# ---------------------------------------------------------------------------
# shared linear-recurrence machinery:  h_t = a_t * h_{t-1} + b_t
# ---------------------------------------------------------------------------

def _assoc_combine(e1, e2):
    """(a1, b1) then (a2, b2): the composed step ``h -> a2 (a1 h + b1) + b2``."""
    a1, b1 = e1
    a2, b2 = e2
    return a2 * a1, a2 * b1 + b2


def _chunk_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of :func:`_assoc_combine` along axis 1: log2(n)
    doubling steps, each combining element t with element t - d."""
    n, d = a.shape[1], 1
    while d < n:
        a_new, b_new = _assoc_combine((a[:, :-d], b[:, :-d]), (a[:, d:], b[:, d:]))
        a = torch.cat([a[:, :d], a_new], dim=1)
        b = torch.cat([b[:, :d], b_new], dim=1)
        d *= 2
    return a, b


def _n_chunks(S: int, chunk: int) -> tuple[int, int]:
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"seq {S} not a multiple of chunk {chunk}")
    return chunk, S // chunk


def chunked_linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                        chunk: int = CHUNK) -> tuple[torch.Tensor, torch.Tensor]:
    """Scan h_t = a_t h_{t-1} + b_t along axis 1 (seq).  Returns (h_all, h_last).

    a, b: (B, S, ...); h0: (B, ...).  S must be a chunk multiple (callers pad).
    """
    chunk, n_chunks = _n_chunks(a.shape[1], chunk)
    h, outs = h0, []
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        acc_a, acc_b = _chunk_scan(a[:, sl], b[:, sl])
        h_all = acc_a * h[:, None] + acc_b
        h = h_all[:, -1]
        outs.append(h_all)
    return torch.cat(outs, dim=1), h


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: torch.Tensor | None = None):
    """Depthwise causal conv.  x: (B, S, C), w: (K, C).  Returns (y, new_state)
    where state carries the last K-1 inputs for decode."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    y = xp[:, 0:S, :] * w[0][None, None, :]
    for i in range(1, K):
        y = y + xp[:, i:i + S, :] * w[i][None, None, :]
    return y, xp[:, -(K - 1):, :]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` in x's dtype (``F.softplus``
    switches to ``x`` above its threshold instead)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------

def init_mamba(b: Builder, cfg: MambaCfg):
    d, di, st, r = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank
    return {
        "in_proj": b.param((d, 2 * di), ("embed_w", "mlp")),
        "conv_w": b.param((cfg.d_conv, di), ("conv", "mlp"), scale=0.5),
        "x_proj": b.param((di, r + 2 * st), ("mlp", "lora")),
        "dt_proj": b.param((r, di), ("lora", "mlp")),
        "dt_bias": b.param((di,), ("mlp",), init="zeros"),
        "A_log": b.param((di, st), ("mlp", "state"), init="ones"),
        "D": b.param((di,), ("mlp",), init="ones"),
        "out_proj": b.param((di, d), ("mlp", "embed_w")),
    }


def _mamba_core(p, xz: torch.Tensor, cfg: MambaCfg, conv_state, ssm_state):
    """Shared train/decode body.  xz: (B, S, 2*di).

    Each chunk computes its own a/b terms in f32, scans them and contracts
    them against C at once.  The casts keep the reference's order:
    ``dt * x`` in the compute dtype, then f32, then times ``B``; the scan's
    output cast back before ``+ x * D`` and ``* silu(z)``.
    """
    di, st = cfg.d_inner, cfg.d_state
    B, S = xz.shape[0], xz.shape[1]
    x, z = xz[..., :di], xz[..., di:]
    x, new_conv = causal_conv1d(x, p["conv_w"], conv_state)
    x = F.silu(x)
    x = shard(x, "batch", "seq", "mlp")

    proj = x @ p["x_proj"]                                  # (B,S,r+2st)
    dt = softplus(proj[..., :cfg.dt_rank] @ p["dt_proj"] + p["dt_bias"])
    Bm = proj[..., cfg.dt_rank:cfg.dt_rank + st]            # (B,S,st)
    Cm = proj[..., cfg.dt_rank + st:]                       # (B,S,st)
    A = -torch.exp(p["A_log"].float())                      # (di,st)

    if ssm_state is None:
        ssm_state = torch.zeros((B, di, st), dtype=torch.float32,
                                device=xz.device)
    chunk, n_chunks = _n_chunks(S, CHUNK)
    h, ys = ssm_state, []
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        dt_i, x_i, b_i, c_i = dt[:, sl], x[:, sl], Bm[:, sl], Cm[:, sl]
        a_i = torch.exp(dt_i[..., None].float() * A[None, None])
        bu_i = (dt_i * x_i)[..., None].float() * b_i[:, :, None, :].float()
        acc_a, acc_b = _chunk_scan(a_i, bu_i)
        h_all = acc_a * h[:, None] + acc_b                  # (B, chunk, di, st)
        ys.append(torch.einsum("bsdn,bsn->bsd", h_all, c_i.float()))
        h = h_all[:, -1]
    y = torch.cat(ys, dim=1)
    y = (y.to(x.dtype) + x * p["D"]) * F.silu(z)
    return y @ p["out_proj"], new_conv, h


def mamba(p, x: torch.Tensor, cfg: MambaCfg) -> torch.Tensor:
    """Training / prefill forward.  x: (B, S, D)."""
    xz = x @ p["in_proj"]
    y, _, _ = _mamba_core(p, xz, cfg, None, None)
    return shard(y, "batch", "seq", "embed")


def mamba_decode(p, x: torch.Tensor, cfg: MambaCfg, state: dict[str, Any]):
    """One-token step.  x: (B, 1, D); state: {'conv': (B,K-1,di), 'ssm': (B,di,st)}."""
    xz = x @ p["in_proj"]
    y, new_conv, new_ssm = _mamba_core(p, xz, cfg, state["conv"], state["ssm"])
    return y, {"conv": new_conv, "ssm": new_ssm}


def mamba_state(cfg: MambaCfg, batch: int, device="cuda") -> dict[str, Any]:
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                            dtype=torch.bfloat16, device=device),
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.d_state),
                           dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma recurrent block)
# ---------------------------------------------------------------------------

def init_rglru(b: Builder, cfg: RGLRUCfg):
    d, w = cfg.d_model, cfg.lru_width
    return {
        "in_x": b.param((d, w), ("embed_w", "mlp")),
        "in_gate": b.param((d, w), ("embed_w", "mlp")),
        "conv_w": b.param((cfg.d_conv, w), ("conv", "mlp"), scale=0.5),
        "gate_a": b.param((w, w), ("mlp", "mlp"), scale=0.01),
        "gate_x": b.param((w, w), ("mlp", "mlp"), scale=0.01),
        "lambda_p": b.param((w,), ("mlp",), init="ones"),
        "out": b.param((w, d), ("mlp", "embed_w")),
    }


def _rglru_core(p, x: torch.Tensor, cfg: RGLRUCfg, conv_state, rnn_state):
    u = x @ p["in_x"]
    gate_branch = F.gelu(x @ p["in_gate"], approximate="tanh")
    u, new_conv = causal_conv1d(u, p["conv_w"], conv_state)
    u = shard(u, "batch", "seq", "mlp")

    r = torch.sigmoid(u @ p["gate_a"])                  # recurrence gate
    i = torch.sigmoid(u @ p["gate_x"])                  # input gate
    log_a = -cfg.c * softplus(p["lambda_p"]).float() * r.float()
    a = torch.exp(log_a)
    gated = (i * u).float()
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * gated
    if rnn_state is None:
        rnn_state = torch.zeros((x.shape[0], u.shape[-1]), dtype=torch.float32,
                                device=x.device)
    h_all, h_last = chunked_linear_scan(a, b, rnn_state)
    y = (h_all.to(x.dtype) * gate_branch) @ p["out"]
    return y, new_conv, h_last


def rglru(p, x: torch.Tensor, cfg: RGLRUCfg) -> torch.Tensor:
    y, _, _ = _rglru_core(p, x, cfg, None, None)
    return shard(y, "batch", "seq", "embed")


def rglru_decode(p, x: torch.Tensor, cfg: RGLRUCfg, state: dict[str, Any]):
    y, new_conv, new_rnn = _rglru_core(p, x, cfg, state["conv"], state["rnn"])
    return y, {"conv": new_conv, "rnn": new_rnn}


def rglru_state(cfg: RGLRUCfg, batch: int, device="cuda") -> dict[str, Any]:
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.lru_width),
                            dtype=torch.bfloat16, device=device),
        "rnn": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                           device=device),
    }
