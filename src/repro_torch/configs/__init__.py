"""Architecture registry: --arch <id> resolves here.

The port's own copy of the JAX package's ``configs`` (plain dataclasses,
the same values), so that the port imports nothing of that package."""
from .base import (SHAPES, ModelConfig, PatternConfig,  # noqa: F401
                   ShapeSpec, TrainConfig)

from . import (deepseek_67b, gemma3_12b, kimi_linear_48b_a3b, mamba2_130m,
               mixtral_8x22b, mixtral_8x7b, nemotron3_nano_30b_a3b,
               qwen1_5_4b, qwen2_5_3b, qwen2_vl_7b, seamless_m4t_large_v2,
               zamba2_2_7b)

REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen2_5_3b, qwen1_5_4b, gemma3_12b, deepseek_67b,
              seamless_m4t_large_v2, mixtral_8x7b, mixtral_8x22b,
              qwen2_vl_7b, mamba2_130m, zamba2_2_7b)
}


# the port's own architectures, which the JAX package does not have
PORT_REGISTRY = {m.CONFIG.name: m.CONFIG
                 for m in (nemotron3_nano_30b_a3b, kimi_linear_48b_a3b)}


def get_config(name: str) -> ModelConfig:
    """An architecture of ``REGISTRY`` or of ``PORT_REGISTRY``."""
    cfg = REGISTRY.get(name) or PORT_REGISTRY.get(name)
    if cfg is None:
        raise KeyError(f"unknown arch {name!r}; have "
                       f"{sorted(REGISTRY) + sorted(PORT_REGISTRY)}")
    return cfg


def applicable_shapes(cfg: ModelConfig):
    """The 4 shape cells for this arch, with long_500k gated on a
    sub-quadratic serving path (DESIGN.md §long_500k skips)."""
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.supports_long_context:
            out.append((s, "skipped: pure full-attention at 512k"))
        else:
            out.append((s, None))
    return out


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Small same-family variant for CPU smoke tests."""
    kw = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=512,
              n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
              head_dim=16, q_chunk=32, kv_chunk=32, dtype="float32")
    if cfg.n_kv_heads == cfg.n_heads:
        kw["n_kv_heads"] = 4
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.family == "hybrid":
        kw.update(n_layers=4, shared_attn_every=2)
    if cfg.family == "encdec":
        kw.update(encoder_layers=2)
    if cfg.n_experts:
        kw.update(n_experts=4)
    if cfg.sliding_window:
        kw.update(sliding_window=16)
    if cfg.local_global_ratio:
        kw.update(local_global_ratio=1, local_window=8)
    if cfg.mrope_sections:
        kw.update(mrope_sections=(4, 2, 2))
    if cfg.family == "pattern" and set(cfg.layer_pattern) & set("KL-"):
        # Kimi Linear's kinds, K and E twice; value heads (16) narrower than
        # query and key heads (16 + 8); every expert held
        kw.update(layer_pattern="K-KELE", n_layers=6, n_experts=8,
                  n_experts_per_tok=2, shared_d_ff=128, dense_d_ff=256,
                  experts_held=None, kda_heads=4, kda_head_dim=16,
                  kda_chunk=16, kv_lora_rank=32, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16)
    elif cfg.family == "pattern":
        # every kind of layer once; d_inner (6 x 16) is not expand x d_model
        kw.update(layer_pattern="MEM*E", n_layers=5, n_heads=8, n_experts=8,
                  n_experts_per_tok=2, ssm_state=16, ssm_head_dim=16,
                  ssm_chunk=16, ssm_heads=6, ssm_groups=2, shared_d_ff=256)
    return cfg.scaled(**kw)
