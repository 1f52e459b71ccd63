"""Decoder-only transformer blocks and their per-layer attention pattern.

The PyTorch port's counterpart of the JAX package's
``models/transformer.py``. Where the reference scans stacked (L, ...)
params with the per-layer window and theta as scanned arrays, the port
keeps one ``nn.ModuleDict`` per layer and loops over them; the pattern is
a pair of host arrays. Not yet ported: MoE feed-forwards, cross attention,
KV caches and ``block_decode`` (ROADMAP A8b).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from . import layers
from .layers import apply_rope, flash_attention, mlp, qkv_project, rmsnorm

Tensor = torch.Tensor


def init_block(cfg: ModelConfig, dtype=torch.bfloat16,
               device="cuda") -> nn.ModuleDict:
    if cfg.n_experts > 0:
        raise NotImplementedError("MoE blocks are not ported yet: ROADMAP A8b")
    return nn.ModuleDict({
        "ln1": layers.init_rmsnorm(cfg.d_model, dtype, device),
        "attn": layers.init_attention(cfg.d_model, cfg.n_heads,
                                      cfg.n_kv_heads, cfg.head_dim,
                                      cfg.qkv_bias, dtype, device),
        "ln2": layers.init_rmsnorm(cfg.d_model, dtype, device),
        "mlp": layers.init_mlp(cfg.d_model, cfg.d_ff, dtype, device),
    })


def block_forward(p, cfg: ModelConfig, x: Tensor, positions: Tensor,
                  window: int, theta: float):
    """Full-sequence causal block (train / prefill). Returns (x, aux); aux
    is the MoE load-balancing loss, 0 without experts."""
    h = rmsnorm(p["ln1"], x, cfg.rms_eps)
    q, k, v = qkv_project(p["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    o = flash_attention(q, k, v, window=window, q_chunk=cfg.q_chunk,
                        kv_chunk=cfg.kv_chunk)
    x = x + o.reshape(x.shape[0], x.shape[1], -1) @ p["attn"]["wo"]
    h = rmsnorm(p["ln2"], x, cfg.rms_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + mlp(p["mlp"], h), aux


def attention_pattern(cfg: ModelConfig, n_layers: int):
    """Returns (window (L,) int32, theta (L,) float32), one per layer."""
    windows = np.full(n_layers, -1, np.int32)
    thetas = np.full(n_layers, cfg.rope_theta, np.float32)
    if cfg.sliding_window > 0:
        windows[:] = cfg.sliding_window
    if cfg.local_global_ratio > 0:
        r = cfg.local_global_ratio
        for i in range(n_layers):
            if (i + 1) % (r + 1) == 0:
                windows[i] = -1                      # global layer
                thetas[i] = cfg.rope_theta_global
            else:
                windows[i] = cfg.local_window
                thetas[i] = cfg.rope_theta
    return windows, thetas
