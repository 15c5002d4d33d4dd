"""AdamW + schedules on tensor trees (no optimizer library).

Counterpart of ``repro/train/optimizer.py``, in its arithmetic order: the
moments in f32, the bias corrections ``1 - b**c`` with ``c`` an f32
tensor, the update ``p - lr·(step + wd·p)`` in f32 cast back to
``p.dtype``, and the global norm summed leaf by leaf in jax's leaf order
(dict keys sorted), so its f32 sum differs from the reference's only by the
order within each leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from ..models.common import tree_flatten_with_paths, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor      # int32 scalar


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_ratio``, in f32."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params) -> OptState:
    """Zero f32 moments beside ``params`` and a zero int32 count on the
    device of the first leaf."""
    zeros = lambda t: tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), t)
    leaves = tree_flatten_with_paths(params)[1]
    return OptState(m=zeros(params), v=zeros(params),
                    count=torch.zeros((), dtype=torch.int32,
                                      device=leaves[0].device))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the f32 sum of squares, leaf sums added in jax's leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in tree_flatten_with_paths(tree)[1]))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: OptState, params):
    """Returns ``(new_params, new_state, stats)``."""
    count = state.count + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    grads = tree_map(lambda g: g.to(torch.float32) * scale, grads)

    m = tree_map(lambda m_, g: cfg.b1 * m_ + (1 - cfg.b1) * g, state.m, grads)
    v = tree_map(lambda v_, g: cfg.b2 * v_ + (1 - cfg.b2) * g * g,
                 state.v, grads)
    c = count.to(torch.float32)
    bc1 = 1 - cfg.b1 ** c
    bc2 = 1 - cfg.b2 ** c
    lr = schedule(cfg, count)

    def upd(p, m_, v_):
        step_ = (m_ / bc1) / (torch.sqrt(v_ / bc2) + cfg.eps)
        pf = p.to(torch.float32)
        return (pf - lr * (step_ + cfg.weight_decay * pf)).to(p.dtype)

    new_params = tree_map(upd, params, m, v)
    return new_params, OptState(m=m, v=v, count=count), {
        "grad_norm": gnorm, "lr": lr}
