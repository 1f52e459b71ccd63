"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal; the audio
frontend is a STUB: input_specs provides precomputed frame embeddings.
[arXiv:2308.11596; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec", n_layers=24,
    encoder_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab_size=256206, head_dim=64, frontend="audio",
)
