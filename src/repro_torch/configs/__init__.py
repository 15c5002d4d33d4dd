"""Assigned-architecture registry: one module per architecture."""
from .base import SHAPES, ArchConfig, ShapeConfig, cell_supported, reduced

from . import (
    deepseek_v3_671b, falcon_mamba_7b, granite_3_2b, granite_moe_3b,
    minitron_4b, paligemma_3b, qwen3_4b, recurrentgemma_9b, smollm_360m,
    whisper_base,
)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (
        qwen3_4b, granite_3_2b, smollm_360m, minitron_4b, falcon_mamba_7b,
        whisper_base, granite_moe_3b, deepseek_v3_671b, recurrentgemma_9b,
        paligemma_3b,
    )
}

__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeConfig", "cell_supported", "reduced"]
