"""deepseek-v3-671b [moe]: 61L d_model=7168 128H (MLA) vocab=129280,
MoE 1 shared + 256 routed top-8 (moe d_ff=2048), first 3 layers dense
(d_ff=18432), sigmoid router.  MTP head omitted (DESIGN.md §4).
[arXiv:2412.19437; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv=128, d_ff=18432,
    vocab=129280, head_dim=128,
    moe=True, n_experts=256, top_k=8, first_k_dense=3, n_shared=1,
    moe_d_ff=2048, router_softmax=False,
    mla=True, q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128,
)
