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
shape) cell.  Every family of the reference is ported: the transformer
(dense, moe, vlm), Mamba (ssm), Griffin (hybrid) and Whisper (audio).
Whisper's prefill is the reference's: it returns a fresh cache.
"""
from __future__ import annotations

import dataclasses
import functools
from collections.abc import Callable
from typing import Any

import torch

from ..configs.base import ArchConfig, ShapeConfig
from . import griffin, mamba_lm, transformer, whisper
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
    "ssm": mamba_lm,
    "hybrid": griffin,
    "audio": whisper,
}


def get_model(cfg: ArchConfig) -> Model:
    mod = _FAMILY_MODULES[cfg.family]
    prefill = _whisper_prefill if cfg.family == "audio" else mod.prefill
    return Model(
        cfg=cfg,
        init=functools.partial(mod.init, cfg),
        loss_fn=functools.partial(mod.loss_fn, cfg),
        full_logits=functools.partial(mod.full_logits, cfg),
        decode_step=functools.partial(mod.decode_step, cfg),
        prefill=functools.partial(prefill, cfg),
        init_cache=functools.partial(mod.init_cache, cfg),
        cache_specs=functools.partial(mod.cache_specs, cfg),
    )


def _whisper_prefill(cfg, params, batch, max_len):
    """Whisper prefill, as the reference's: encode the frames and run the
    decoder prefix through ``decode_train`` for the last logits, then return
    a fresh :func:`whisper.init_cache` (no self K/V, zero cross K/V,
    position 0) — decoding does not continue from the prefix."""
    enc_out = whisper.encode(cfg, params, batch["frames"])
    x = whisper.decode_train(cfg, params, batch["tokens"], enc_out)
    logits = transformer.logits_fn(cfg, params, x[:, -1:, :])
    cache = whisper.init_cache(cfg, batch["tokens"].shape[0], max_len,
                               device=batch["tokens"].device)
    return logits, cache


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
