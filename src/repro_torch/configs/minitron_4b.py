"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000, pruned nemotron.  [arXiv:2407.14679; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv=8, d_ff=9216, vocab=256000,
    head_dim=128,
)
