"""qwen3-moe-235b-a22b — MoE 94L d4096 64H(kv4) 128e top-8 ff_e1536
v151936 [hf:Qwen]."""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, d_ff=1536, vocab=151936, head_dim=128,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
    rope_theta=1000000.0,
    remat_block=8,   # hierarchical remat: 94 = 11×8 + 6 (§Perf)
)
