"""qwen2.5-3b [dense] — GQA kv=2, QKV bias. [hf:Qwen/Qwen2.5-*; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense", n_layers=36, d_model=2048,
    n_heads=16, n_kv_heads=2, d_ff=11008, vocab_size=151936,
    head_dim=128, qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
)
