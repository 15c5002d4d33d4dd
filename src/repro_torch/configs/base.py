"""Architecture + shape configuration registry.

Every assigned architecture is a frozen :class:`ArchConfig`; the four
assigned input shapes are :class:`ShapeConfig` entries.  ``reduced()``
derives the CPU smoke-test variant of any config (same family/topology,
small dims).  Parameters are held in ``param_dtype`` (float32) and computed
in ``compute_dtype`` (bfloat16), as torch dtypes.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    qk_norm: bool = False
    act: str = "silu"
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    first_k_dense: int = 0
    n_shared: int = 0
    moe_d_ff: int = 0
    router_softmax: bool = True
    capacity_factor: float = 1.25
    # --- MLA (deepseek) ---
    mla: bool = False
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_head: int = 0
    # --- SSM ---
    ssm_state: int = 16
    d_conv: int = 4
    expand: int = 2
    # --- hybrid (recurrentgemma) ---
    window: int | None = None
    lru_width: int = 0
    # --- enc-dec (whisper) ---
    enc_layers: int = 0
    enc_frames: int = 1500
    # --- vlm (paligemma) ---
    prefix_tokens: int = 0
    # --- runtime ---
    kv_quant: bool = False      # HSZ stage-③ KV residency
    fsdp_bf16_gather: bool = False  # cast params to bf16 BEFORE the FSDP gather
    remat: str = "full"         # none | full | dots
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # sub-quadratic context path (SSM / hybrid): eligible for long_500k
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def param_count(self) -> int:
        """Approximate parameter count (reported in the roofline table)."""
        d, v, L = self.d_model, self.vocab, self.n_layers
        total = 2 * v * d  # embed + head
        hd = self.head_dim
        if self.family == "ssm":
            di = self.expand * d
            per = d * 2 * di + self.d_conv * di + di * (max(1, d // 16) + 2 * self.ssm_state) \
                + max(1, d // 16) * di + di * self.ssm_state + di * d
            return total + L * per
        if self.mla:
            attn = (d * self.q_lora + self.q_lora * self.n_heads * (self.qk_nope + self.qk_rope)
                    + d * (self.kv_lora + self.qk_rope)
                    + self.kv_lora * self.n_heads * (self.qk_nope + self.v_head)
                    + self.n_heads * self.v_head * d)
        else:
            attn = d * self.n_heads * hd + 2 * d * self.n_kv * hd + self.n_heads * hd * d
        if self.family == "hybrid":
            w = self.lru_width or d
            rec = 2 * d * w + self.d_conv * w + 2 * w * w + w + w * d
            n_attn = L // 3
            n_rec = L - n_attn
            per_mlp = 3 * d * self.d_ff
            return total + n_rec * (rec + per_mlp) + n_attn * (attn + per_mlp)
        if self.moe:
            f = self.moe_d_ff or self.d_ff
            moe_per = d * self.n_experts + 3 * self.n_experts * d * f \
                + (3 * d * f * self.n_shared if self.n_shared else 0)
            dense_per = 3 * d * self.d_ff
            return total + self.first_k_dense * (attn + dense_per) \
                + (L - self.first_k_dense) * (attn + moe_per)
        return total + L * (attn + 3 * d * self.d_ff)

    @property
    def active_param_count(self) -> int:
        """Active params per token (= param_count for dense models)."""
        if not self.moe:
            return self.param_count
        f = self.moe_d_ff or self.d_ff
        d, L = self.d_model, self.n_layers
        inactive = (L - self.first_k_dense) * 3 * (self.n_experts - self.top_k) * d * f
        return self.param_count - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def cell_supported(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch × shape) cell is defined (DESIGN.md §4)."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, "pure full-attention arch: O(S^2) at 524288 has no sub-quadratic path"
    return True, ""


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Same-family smoke-test variant: small dims, few layers, tiny vocab."""
    repl = dict(
        n_layers=min(cfg.n_layers, 3 if cfg.family == "hybrid" else 2),
        d_model=64, n_heads=4, n_kv=max(1, min(cfg.n_kv, 2)), head_dim=16,
        d_ff=128, vocab=256,
    )
    if cfg.family == "hybrid":
        repl.update(n_layers=4, lru_width=64, window=16)
    if cfg.moe:
        repl.update(n_experts=min(cfg.n_experts, 8), top_k=min(cfg.top_k, 2),
                    moe_d_ff=32, first_k_dense=min(cfg.first_k_dense, 1),
                    capacity_factor=8.0)  # no token drops: decode parity
    if cfg.mla:
        repl.update(q_lora=32, kv_lora=16, qk_nope=16, qk_rope=8, v_head=16)
    if cfg.family == "audio":
        repl.update(enc_layers=2, enc_frames=8)
    if cfg.family == "vlm":
        repl.update(prefix_tokens=4)
    if cfg.family == "ssm":
        repl.update(ssm_state=4, expand=2)
    return dataclasses.replace(cfg, **repl)
