"""whisper-small — enc-dec 12+12L d768 12H ff3072 v51865, conv frontend stub
[arXiv:2212.04356]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec", n_layers=12, n_enc_layers=12,
    d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072, vocab=51865,
)
