"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152,
llama-arch small.  [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv=5, d_ff=2560, vocab=49152,
    head_dim=64,
)
