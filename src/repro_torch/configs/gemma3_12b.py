"""gemma3-12b [dense] — 5:1 local:global attention, window 1024, 128k
context. [hf:google/gemma-3-12b-pt; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense", n_layers=48, d_model=3840,
    n_heads=16, n_kv_heads=8, d_ff=15360, vocab_size=262144,
    head_dim=256, local_global_ratio=5, local_window=1024,
    rope_theta=1e4, rope_theta_global=1e6, tie_embeddings=True,
)
