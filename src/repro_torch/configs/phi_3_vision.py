"""phi-3-vision-4.2b — VLM: phi3-mini backbone + CLIP patch-embed stub
[hf:microsoft/Phi-3-vision-128k-instruct]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32064,
    rope_theta=10000.0, frontend_positions=1024,
)
