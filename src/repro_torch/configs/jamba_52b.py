"""jamba-v0.1-52b — hybrid Mamba+attn 1:7, MoE 16e top-2, 32L d4096
32H(kv8) ff14336 v65536 [arXiv:2403.19887]."""
from ..models.config import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=65536,
    attn_every=8, attn_offset=4,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, chunk=256),
    subquadratic=True,
)
