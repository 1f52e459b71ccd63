"""qwen1.5-4b [dense] — MHA (kv = heads), QKV bias. [hf:Qwen/Qwen1.5-*; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense", n_layers=40, d_model=2560,
    n_heads=20, n_kv_heads=20, d_ff=6912, vocab_size=151936,
    head_dim=128, qkv_bias=True, rope_theta=1e6,
)
