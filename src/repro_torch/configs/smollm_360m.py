"""smollm-360m — dense 32L d960 15H(kv5) ff2560 v49152 [hf:HuggingFaceTB/SmolLM]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense", n_layers=32, d_model=960,
    n_heads=15, n_kv_heads=5, d_ff=2560, vocab=49152, head_dim=64,
    rope_theta=10000.0, tie_embeddings=True,
)
