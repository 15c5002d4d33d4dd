"""Attention variants: GQA (+qk-norm, RoPE, sliding window), MLA, KV caches.

Covers every transformer-family architecture's attention: qwen3 (GQA +
per-head qk-norm), granite/minitron (GQA), smollm (GQA kv=5), paligemma
(MQA), deepseek-v3 (MLA with latent KV cache), and whisper-style cross
attention.  Decode paths read/write a preallocated cache (shape-stable);
the cache optionally holds stage-③ quantized integers (HSZ residency, int8
+ per-head scale) — the framework-level analogue of the paper's "operate on
D_q instead of D_f".

Attention is the grouped einsum of the reference (``sdpa``): f32 logits
times the scale, masked with -1e30, an f32 softmax cast to the value dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .common import Builder, axis_size, causal_mask, rms_norm, rope, shard


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: int | None = None      # sliding-window (local) attention
    use_rope: bool = True
    causal: bool = True
    # MLA (deepseek-v3)
    mla: bool = False
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_dim: int = 0
    # KV-cache quantization (HSZ stage-③ residency)
    kv_quant: bool = False


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(b: Builder, cfg: AttnCfg):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    if cfg.mla:
        return {
            "q_a": b.param((d, cfg.q_lora), ("embed_w", "lora")),
            "q_a_norm": b.param((cfg.q_lora,), ("lora",), init="zeros"),
            "q_b": b.param((cfg.q_lora, h * (cfg.qk_nope + cfg.qk_rope)), ("lora", "heads")),
            "kv_a": b.param((d, cfg.kv_lora + cfg.qk_rope), ("embed_w", "lora")),
            "kv_a_norm": b.param((cfg.kv_lora,), ("lora",), init="zeros"),
            "kv_b": b.param((cfg.kv_lora, h * (cfg.qk_nope + cfg.v_dim)), ("lora", "heads")),
            "o": b.param((h * cfg.v_dim, d), ("heads", "embed_w")),
        }
    p = {
        "wq": b.param((d, h * hd), ("embed_w", "heads")),
        "wk": b.param((d, kv * hd), ("embed_w", "kv_heads")),
        "wv": b.param((d, kv * hd), ("embed_w", "kv_heads")),
        "wo": b.param((h * hd, d), ("heads", "embed_w")),
    }
    if cfg.qk_norm:
        p["q_norm"] = b.param((hd,), ("head_dim",), init="zeros")
        p["k_norm"] = b.param((hd,), ("head_dim",), init="zeros")
    return p


# ---------------------------------------------------------------------------
# core scaled-dot-product with GQA head grouping
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor | None, scale: float) -> torch.Tensor:
    """q: (B,S,H,hd)  k/v: (B,T,Kh,hd or vd)  -> (B,S,H,vd).

    Head grouping: H = Kh * G; computed grouped to avoid materializing
    repeated K/V (the GQA memory win).
    """
    B, S, H, hd = q.shape
    Kh = k.shape[2]
    G = H // Kh
    qg = q.reshape(B, S, Kh, G, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    if mask is not None:
        m = mask[:, None, None, :, :] if mask.ndim == 3 else mask
        logits = logits.masked_fill(~m, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, H, v.shape[-1])


# ---------------------------------------------------------------------------
# GQA forward (train / prefill)
# ---------------------------------------------------------------------------

def _project_qkv(p, x, cfg: AttnCfg, positions):
    B, S, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, h, hd)
    k = (x @ p["wk"]).reshape(B, S, kv, hd)
    v = (x @ p["wv"]).reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if h % max(axis_size("heads"), 1) == 0:
        q = shard(q, "batch", "seq", "heads", None)
    else:
        # sequence-parallel fallback: head count (e.g. 15, 8) does not divide
        # the TP extent — shard attention over the query-sequence dim instead
        q = shard(q, "batch", "seq_tp", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    v = shard(v, "batch", "seq", "kv_heads", None)
    return q, k, v


def forward(p, x: torch.Tensor, cfg: AttnCfg, positions: torch.Tensor,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Self-attention over a full sequence (training / prefill)."""
    if cfg.mla:
        return _mla_forward(p, x, cfg, positions, mask)
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    if mask is None and cfg.causal:
        mask = causal_mask(S, S, window=cfg.window, device=x.device)
    out = sdpa(q, k, v, mask, 1.0 / (cfg.head_dim ** 0.5))
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return shard(out @ p["wo"], "batch", "seq", "embed")


def forward_chunked(p, x: torch.Tensor, cfg: AttnCfg, positions: torch.Tensor,
                    q_chunk: int = 2048) -> torch.Tensor:
    """Query-chunked attention for long prefill: bounds the live logits
    buffer to (B, H, q_chunk, kv_len).

    For sliding-window configs, keys are pre-shifted so each query chunk
    attends to a static (q_chunk + window) key band instead of the full
    sequence — O(S·W) instead of O(S²).
    """
    B, S, _ = x.shape
    if S <= q_chunk:
        return forward(p, x, cfg, positions)
    if S % q_chunk:  # prefix-LM shapes (e.g. 256+4096): largest divisor wins
        q_chunk = next(d for d in range(q_chunk, 0, -1) if S % d == 0)
        if q_chunk < 64:
            return forward(p, x, cfg, positions)
    if cfg.mla:
        q, k, v, _, _ = _mla_qkv(p, x, cfg, positions)
        scale = 1.0 / ((cfg.qk_nope + cfg.qk_rope) ** 0.5)
        o_name, o_dim = "o", cfg.n_heads * cfg.v_dim
    else:
        q, k, v = _project_qkv(p, x, cfg, positions)
        scale = 1.0 / (cfg.head_dim ** 0.5)
        o_name, o_dim = "wo", cfg.n_heads * cfg.head_dim
    w = cfg.window
    H = q.shape[2]
    nc = S // q_chunk
    q_chunks = q.reshape(B, nc, q_chunk, H, -1)
    head_ok = H % max(axis_size("heads"), 1) == 0
    q_axes = ("batch", "seq", "heads", None) if head_ok else \
             ("batch", "seq_tp", "heads", None)
    dev = x.device
    outs = []
    if w is not None:
        band = ((w + q_chunk - 1) // q_chunk) * q_chunk  # static key look-back
        kp = torch.nn.functional.pad(k, (0, 0, 0, 0, band, 0))
        vp = torch.nn.functional.pad(v, (0, 0, 0, 0, band, 0))
        for idx in range(nc):
            qi = shard(q_chunks[:, idx], *q_axes)
            s0 = idx * q_chunk
            ki = kp[:, s0:s0 + band + q_chunk]
            vi = vp[:, s0:s0 + band + q_chunk]
            q_pos = s0 + torch.arange(q_chunk, device=dev)[:, None]
            kv_pos = s0 - band + torch.arange(band + q_chunk, device=dev)[None, :]
            mask = (kv_pos <= q_pos) & (kv_pos > q_pos - w) & (kv_pos >= 0)
            outs.append(sdpa(qi, ki, vi, mask, scale))
    else:
        for idx in range(nc):
            qi = shard(q_chunks[:, idx], *q_axes)
            q_pos = idx * q_chunk + torch.arange(q_chunk, device=dev)[:, None]
            mask = torch.arange(S, device=dev)[None, :] <= q_pos
            outs.append(sdpa(qi, k, v, mask, scale))
    out = torch.stack(outs, dim=1).reshape(B, S, o_dim)
    return shard(out @ p[o_name], "batch", "seq", "embed")


def cross_forward(p, x: torch.Tensor, kv_src: torch.Tensor,
                  cfg: AttnCfg) -> torch.Tensor:
    """Cross-attention (whisper decoder): queries from x, keys/values from
    encoder output; no RoPE, no causal mask."""
    B, S, _ = x.shape
    T = kv_src.shape[1]
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, h, hd)
    k = (kv_src @ p["wk"]).reshape(B, T, kv, hd)
    v = (kv_src @ p["wv"]).reshape(B, T, kv, hd)
    out = sdpa(q, k, v, None, 1.0 / hd ** 0.5).reshape(B, S, h * hd)
    return out @ p["wo"]


def project_kv(p, x: torch.Tensor, cfg: AttnCfg, positions: torch.Tensor):
    """KV-cache entries for a full sequence (prefill cache construction).

    GQA -> {'k','v'}: (B,S,kv,hd); MLA -> {'latent'}: (B,S,kv_lora+rope).
    """
    if cfg.mla:
        kv_a = x @ p["kv_a"]
        c_kv = rms_norm(kv_a[..., :cfg.kv_lora], p["kv_a_norm"])
        k_rope = rope(kv_a[..., None, cfg.kv_lora:], positions, cfg.rope_theta)[:, :, 0]
        return {"latent": torch.cat([c_kv, k_rope], dim=-1)}
    _, k, v = _project_qkv(p, x, cfg, positions)
    return {"k": k, "v": v}


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

def init_cache(cfg: AttnCfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device="cuda") -> dict[str, Any]:
    """Preallocated cache; int8 payload + f32 scale when kv_quant is set."""
    z = dict(device=device)
    if cfg.mla:
        width = cfg.kv_lora + cfg.qk_rope
        if cfg.kv_quant:
            return {"latent": torch.zeros((batch, max_len, width), dtype=torch.int8, **z),
                    "scale": torch.ones((), dtype=torch.float32, **z)}
        return {"latent": torch.zeros((batch, max_len, width), dtype=dtype, **z)}
    kv_shape = (batch, max_len, cfg.n_kv, cfg.head_dim)
    if cfg.kv_quant:
        return {"k": torch.zeros(kv_shape, dtype=torch.int8, **z),
                "v": torch.zeros(kv_shape, dtype=torch.int8, **z),
                "k_scale": torch.ones((cfg.n_kv,), dtype=torch.float32, **z),
                "v_scale": torch.ones((cfg.n_kv,), dtype=torch.float32, **z)}
    return {"k": torch.zeros(kv_shape, dtype=dtype, **z),
            "v": torch.zeros(kv_shape, dtype=dtype, **z)}


def _scale_for(cache, name, buf):
    """Broadcast the per-head (or scalar) scale against (B, S, kv, hd)."""
    scale = cache.get(f"{name}_scale", cache.get("scale"))
    if scale.ndim == 1 and buf.ndim == 4:   # (kv,) -> (1, 1, kv, 1)
        scale = scale[None, None, :, None]
    return scale


def _cache_write(cache, name, val, pos):
    """Write a (B, 1, ...) value at time ``pos`` (quantizing if the cache is
    int8) into a new buffer.  A ``pos`` past the end writes the last row,
    as the reference's ``dynamic_update_slice`` clamps its start."""
    buf = cache[name]
    if buf.dtype == torch.int8:
        scale = _scale_for(cache, name, buf)
        val = torch.clamp(torch.round(val.float() / scale), -127, 127)
    at = torch.clamp(torch.as_tensor(pos, device=buf.device),
                     0, buf.shape[1] - 1).reshape(1).long()
    return buf.index_copy(1, at, val.to(buf.dtype))


def _cache_read(cache, name):
    buf = cache[name]
    if buf.dtype == torch.int8:
        return buf.float() * _scale_for(cache, name, buf)
    return buf


def decode_step(p, x: torch.Tensor, cfg: AttnCfg, cache: dict[str, Any],
                pos: torch.Tensor) -> tuple[torch.Tensor, dict[str, Any]]:
    """One-token self-attention against the cache.  x: (B, 1, D)."""
    if cfg.mla:
        return _mla_decode(p, x, cfg, cache, pos)
    B = x.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    positions = torch.as_tensor(pos, device=x.device).to(torch.int32).expand(B, 1)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    cache = dict(cache)
    cache["k"] = _cache_write(cache, "k", k_new, pos)
    cache["v"] = _cache_write(cache, "v", v_new, pos)
    k = _cache_read(cache, "k").to(q.dtype)
    v = _cache_read(cache, "v").to(q.dtype)
    T = k.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    valid = t <= pos
    if cfg.window is not None:
        valid &= t > pos - cfg.window
    out = sdpa(q, k, v, valid[None, :, :], 1.0 / hd ** 0.5)
    out = out.reshape(B, 1, h * hd)
    return out @ p["wo"], cache


# ---------------------------------------------------------------------------
# MLA (deepseek-v3)
# ---------------------------------------------------------------------------

def _mla_qkv(p, x, cfg: AttnCfg, positions):
    """Project to per-head q/k/v from the latent (training path)."""
    B, S, _ = x.shape
    h = cfg.n_heads
    qa = rms_norm(x @ p["q_a"], p["q_a_norm"])
    q = (qa @ p["q_b"]).reshape(B, S, h, cfg.qk_nope + cfg.qk_rope)
    q_nope, q_rope = q[..., :cfg.qk_nope], q[..., cfg.qk_nope:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    kv_a = x @ p["kv_a"]
    c_kv = rms_norm(kv_a[..., :cfg.kv_lora], p["kv_a_norm"])
    k_rope = rope(kv_a[..., None, cfg.kv_lora:], positions, cfg.rope_theta)  # 1 shared head
    kvb = (c_kv @ p["kv_b"]).reshape(B, S, h, cfg.qk_nope + cfg.v_dim)
    k_nope, v = kvb[..., :cfg.qk_nope], kvb[..., cfg.qk_nope:]

    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:-1], cfg.qk_rope)],
                       dim=-1)
    q_full = shard(q_full, "batch", "seq", "heads", None)
    k_full = shard(k_full, "batch", "seq", "heads", None)
    v = shard(v, "batch", "seq", "heads", None)
    return q_full, k_full, v, c_kv, kv_a[..., cfg.kv_lora:]


def _mla_forward(p, x, cfg: AttnCfg, positions, mask):
    B, S, _ = x.shape
    q, k, v, _, _ = _mla_qkv(p, x, cfg, positions)
    if mask is None and cfg.causal:
        mask = causal_mask(S, S, device=x.device)
    scale = 1.0 / ((cfg.qk_nope + cfg.qk_rope) ** 0.5)
    out = sdpa(q, k, v, mask, scale).reshape(B, S, cfg.n_heads * cfg.v_dim)
    return shard(out @ p["o"], "batch", "seq", "embed")


def _mla_decode(p, x, cfg: AttnCfg, cache, pos):
    """Latent-cache decode: the cache holds (c_kv ++ rope_k) per token —
    MLA's compressed KV (itself a learned compression; composes with HSZ
    int8 residency when kv_quant is on)."""
    B = x.shape[0]
    h = cfg.n_heads
    positions = torch.as_tensor(pos, device=x.device).to(torch.int32).expand(B, 1)
    qa = rms_norm(x @ p["q_a"], p["q_a_norm"])
    q = (qa @ p["q_b"]).reshape(B, 1, h, cfg.qk_nope + cfg.qk_rope)
    q_nope, q_rope = q[..., :cfg.qk_nope], q[..., cfg.qk_nope:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    kv_a = x @ p["kv_a"]
    c_kv = rms_norm(kv_a[..., :cfg.kv_lora], p["kv_a_norm"])
    k_rope_new = rope(kv_a[..., None, cfg.kv_lora:], positions, cfg.rope_theta)[:, :, 0]
    latent_new = torch.cat([c_kv, k_rope_new], dim=-1)
    cache = dict(cache)
    cache["latent"] = _cache_write(cache, "latent", latent_new, pos)
    latent = _cache_read(cache, "latent")
    c_all = latent[..., :cfg.kv_lora].to(x.dtype)      # (B, T, kv_lora)
    kr_all = latent[..., cfg.kv_lora:].to(x.dtype)     # (B, T, rope)

    # absorbed attention: score = q_nope^T (W_kb c) + q_rope^T k_rope
    wkb = p["kv_b"].reshape(cfg.kv_lora, h, cfg.qk_nope + cfg.v_dim)
    wk_nope = wkb[..., :cfg.qk_nope]      # (kv_lora, h, nope)
    wv = wkb[..., cfg.qk_nope:]           # (kv_lora, h, vd)
    q_abs = torch.einsum("bqhn,lhn->bqhl", q_nope, wk_nope)  # q into latent
    T = c_all.shape[1]
    scale = 1.0 / ((cfg.qk_nope + cfg.qk_rope) ** 0.5)
    logits = (torch.einsum("bqhl,btl->bhqt", q_abs, c_all)
              + torch.einsum("bqhr,btr->bhqt", q_rope, kr_all)).float() * scale
    valid = torch.arange(T, device=x.device)[None, None, None, :] <= pos
    logits = logits.masked_fill(~valid, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqt,btl->bqhl", w, c_all)           # (B,1,h,kv_lora)
    out = torch.einsum("bqhl,lhv->bqhv", ctx, wv).reshape(B, 1, h * cfg.v_dim)
    return out @ p["o"], cache
