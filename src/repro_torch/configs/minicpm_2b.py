"""minicpm-2b — dense 40L d2304 36H(kv36) ff5760 v122753, WSD [arXiv:2404.06395]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense", n_layers=40, d_model=2304,
    n_heads=36, n_kv_heads=36, d_ff=5760, vocab=122753,
    rope_theta=10000.0, tie_embeddings=True,
)
