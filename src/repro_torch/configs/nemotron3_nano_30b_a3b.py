"""nemotron3-nano-30b-a3b [pattern] — NVIDIA-Nemotron-3-Nano-30B-A3B: 52
layers of one mixer each, 23 Mamba2 (64 heads x 64, 8 groups of B and C,
state 128), 23 sparse-expert MLPs (128 relu^2 experts of 1,856, 6 a token
by sigmoid scores with a correction bias, normalised and scaled by 2.5,
one shared expert of 3,712) and 6 GQA attention layers (32 / 2 heads of
128, no rotary embedding), at hidden size 2,688.
[https://huggingface.co/nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16; hf]"""
from .base import PatternConfig

CONFIG = PatternConfig(
    name="nemotron3-nano-30b-a3b", family="pattern", n_layers=52,
    d_model=2688, n_heads=32, n_kv_heads=2, d_ff=1856, vocab_size=131072,
    head_dim=128, n_experts=128, n_experts_per_tok=6, ssm_state=128,
    ssm_head_dim=64, ssm_chunk=128, rms_eps=1e-5,
    layer_pattern="MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME",
    ssm_heads=64, ssm_groups=8, shared_d_ff=3712, routed_scaling=2.5,
    norm_topk_prob=True, router_groups=1, router_topk_groups=1,
    supports_long_context=True,
)
