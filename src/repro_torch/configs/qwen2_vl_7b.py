"""qwen2-vl-7b [vlm] — M-RoPE (t/h/w sections), dynamic resolution; vision
frontend STUBBED (input_specs provides patch embeddings + 3-D positions).
[arXiv:2409.12191; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm", n_layers=28, d_model=3584,
    n_heads=28, n_kv_heads=4, d_ff=18944, vocab_size=152064,
    head_dim=128, qkv_bias=True, rope_theta=1e6,
    mrope_sections=(16, 24, 24), frontend="vision",
)
