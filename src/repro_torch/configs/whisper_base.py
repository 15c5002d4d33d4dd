"""whisper-base [audio]: 6L (decoder) + 6L encoder, d_model=512 8H d_ff=2048
vocab=51865; enc-dec with conv frontend STUB (input_specs provides
precomputed frame embeddings).  [arXiv:2212.04356; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv=8, d_ff=2048, vocab=51865,
    head_dim=64, enc_layers=6, enc_frames=1500,
)
