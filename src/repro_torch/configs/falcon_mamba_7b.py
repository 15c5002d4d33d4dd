"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attn-free) d_ff=0 vocab=65024,
ssm_state=16, mamba-1 arch.  [arXiv:2410.05355; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv=1, d_ff=0, vocab=65024,
    head_dim=64, ssm_state=16, d_conv=4, expand=2, subquadratic=True,
)
