"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216; SigLIP frontend STUB (input_specs provides 256 precomputed
patch embeddings) + gemma decoder.  [arXiv:2407.07726; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv=1, d_ff=16384, vocab=257216,
    head_dim=256, act="gelu", prefix_tokens=256,
)
