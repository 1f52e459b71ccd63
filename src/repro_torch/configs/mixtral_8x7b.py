"""mixtral-8x7b [moe] — 8 experts top-2, SWA 4096. [arXiv:2401.04088; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=32000,
    head_dim=128, n_experts=8, n_experts_per_tok=2, sliding_window=4096,
    rope_theta=1e6, supports_long_context=True,  # SWA rolling-buffer cache
)
