"""kimi-linear-48b-a3b [pattern] — Kimi-Linear-48B-A3B: 27 layers of a
mixer and an FFN each, 54 sublayers. Mixers: 20 Kimi Delta Attention (32
heads x 128, conv 4) and 7 latent attention (MLA: kv_lora_rank 512, query
and key heads of 128 + 64, value heads of 128, 32 heads, no rotary
embedding). FFNs: a dense SwiGLU of 9,216 in layer 1, then 26 sparse-expert
MLPs (256 SwiGLU experts of 1,024, 8 a token by sigmoid scores with a
correction bias, renormalised and scaled by 2.446, one shared SwiGLU
expert of 1,024), at hidden size 2,304. This card holds experts 0-127 of
every expert layer: a 2-card expert-parallel deployment's share.
[https://huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct; hf]"""
from .base import PatternConfig

CONFIG = PatternConfig(
    name="kimi-linear-48b-a3b", family="pattern", n_layers=54,
    d_model=2304, n_heads=32, n_kv_heads=32, d_ff=1024, vocab_size=163840,
    head_dim=72, n_experts=256, n_experts_per_tok=8, rms_eps=1e-5,
    layer_pattern="K-KEKELE" + "KEKEKELE" * 5 + "KEKELE",
    shared_d_ff=1024, routed_scaling=2.446, norm_topk_prob=True,
    router_groups=1, router_topk_groups=1, gated_experts=True,
    experts_held=range(0, 128), kda_heads=32, kda_head_dim=128, kda_conv=4,
    kda_chunk=64, kv_lora_rank=512, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128, dense_d_ff=9216,
    supports_long_context=True,
)
