"""Architecture registry: --arch <id> resolves here.

The port's own copy of the JAX package's ``configs`` (plain dataclasses,
the same values), so that the port imports nothing of that package."""
from .base import SHAPES, ModelConfig, ShapeSpec, TrainConfig  # noqa: F401

from . import (deepseek_67b, gemma3_12b, mamba2_130m, mixtral_8x22b,
               mixtral_8x7b, qwen1_5_4b, qwen2_5_3b, qwen2_vl_7b,
               seamless_m4t_large_v2, zamba2_2_7b)

REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen2_5_3b, qwen1_5_4b, gemma3_12b, deepseek_67b,
              seamless_m4t_large_v2, mixtral_8x7b, mixtral_8x22b,
              qwen2_vl_7b, mamba2_130m, zamba2_2_7b)
}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


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
    return cfg.scaled(**kw)
