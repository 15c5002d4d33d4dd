"""Model factory: ArchConfig -> uniform Model facade.

Every architecture exposes the same entry points, so the server is
architecture-agnostic:

    init(generator, device=) -> (params, logical_specs)
    loss_fn(params, batch) -> scalar
    full_logits(params, batch) -> (B, S, V) f32
    prefill(params, batch, max_len) -> (logits, cache)
    decode_step(params, tokens, cache) -> (logits, cache)
    init_cache(batch, max_len, device=) / cache_specs(batch, max_len)

``input_specs`` gives ``meta`` tensors for every model input of an (arch ×
shape) cell.  The transformer family (dense, moe, vlm) is ported; the
``ssm``, ``hybrid`` and ``audio`` families are not yet (ROADMAP queue 1
item 2b), and :func:`get_model` raises for them.
"""
from __future__ import annotations

import dataclasses
import functools
from collections.abc import Callable
from typing import Any

import torch

from ..configs.base import ArchConfig, ShapeConfig
from . import transformer
from .common import resolve_device


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., Any]
    loss_fn: Callable[[Any, dict[str, torch.Tensor]], torch.Tensor]
    full_logits: Callable[[Any, dict[str, torch.Tensor]], torch.Tensor]
    decode_step: Callable[[Any, torch.Tensor, Any], Any]
    prefill: Callable[[Any, dict[str, torch.Tensor], int], Any]
    init_cache: Callable[..., Any]
    cache_specs: Callable[[int, int], Any]


_FAMILY_MODULES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
}
#: families of the reference whose modules are not ported yet
_NOT_PORTED = {"ssm": "models/ssm.py, models/mamba_lm.py",
               "hybrid": "models/griffin.py", "audio": "models/whisper.py"}


def get_model(cfg: ArchConfig) -> Model:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family ({_NOT_PORTED[cfg.family]}) "
            "is not ported yet (ROADMAP queue 1 item 2b)")
    mod = _FAMILY_MODULES[cfg.family]
    return Model(
        cfg=cfg,
        init=functools.partial(mod.init, cfg),
        loss_fn=functools.partial(mod.loss_fn, cfg),
        full_logits=functools.partial(mod.full_logits, cfg),
        decode_step=functools.partial(mod.decode_step, cfg),
        prefill=functools.partial(mod.prefill, cfg),
        init_cache=functools.partial(mod.init_cache, cfg),
        cache_specs=functools.partial(mod.cache_specs, cfg),
    )


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict[str, torch.Tensor]:
    """``meta`` stand-ins for the model inputs of one cell."""
    B = shape.global_batch
    meta = functools.partial(torch.empty, device="meta")
    if shape.kind == "decode":
        return {"tokens": meta((B, 1), dtype=torch.int32)}
    S = shape.seq_len
    specs = {"tokens": meta((B, S), dtype=torch.int32)}
    if cfg.family == "audio":
        specs["frames"] = meta((B, cfg.enc_frames, cfg.d_model),
                               dtype=torch.float32)
    if cfg.family == "vlm":
        specs["prefix_embeds"] = meta((B, cfg.prefix_tokens, cfg.d_model),
                                      dtype=torch.float32)
    return specs


def make_batch(cfg: ArchConfig, shape: ShapeConfig,
               generator: torch.Generator, device="cuda") -> dict[str, torch.Tensor]:
    """Concrete random batch matching input_specs, drawn from ``generator``
    on its own device and moved to ``device``."""
    device = resolve_device(device)
    out = {}
    for name, spec in input_specs(cfg, shape).items():
        if spec.dtype.is_floating_point:
            value = torch.randn(spec.shape, generator=generator,
                                dtype=spec.dtype, device=generator.device)
        else:
            value = torch.randint(0, cfg.vocab, spec.shape, generator=generator,
                                  dtype=spec.dtype, device=generator.device)
        out[name] = value.to(device)
    return out
