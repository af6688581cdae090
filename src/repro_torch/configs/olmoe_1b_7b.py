"""olmoe-1b-7b — MoE 16L d2048 16H(kv16) 64e top-8 ff_e1024 v50304
[arXiv:2409.02060]."""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1024, vocab=50304,
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
    rope_theta=10000.0,
)
