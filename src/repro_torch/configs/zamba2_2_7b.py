"""zamba2-2.7b [hybrid] — Mamba2 backbone + one shared transformer block
applied every 6 layers. [arXiv:2411.15242; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab_size=32000,
    head_dim=80, ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    ssm_chunk=64, shared_attn_every=6, supports_long_context=True,
)
