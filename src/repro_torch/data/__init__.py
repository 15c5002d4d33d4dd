"""Data pipelines: synthetic LM tokens + compressed scientific fields."""
from . import scientific, tokens
from .scientific import CompressedShard, ScientificStore
from .tokens import TokenPipeline, TokenPipelineConfig

__all__ = ["CompressedShard", "ScientificStore", "TokenPipeline",
           "TokenPipelineConfig", "scientific", "tokens"]
