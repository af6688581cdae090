"""rwkv6-1.6b (Finch) — attn-free 24L d2048 ff7168 v65536 [arXiv:2404.05892]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048,
    n_heads=0, n_kv_heads=0, d_ff=7168, vocab=65536,
    subquadratic=True,
    wkv_chunk=32,    # chunked-parallel WKV (identical math, §Perf)
)
