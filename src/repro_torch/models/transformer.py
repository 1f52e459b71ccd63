"""Transformer blocks (dense or MoE feed-forward, optional cross
attention), their KV cache and decode step, and the per-layer attention
pattern.

The PyTorch port's counterpart of the JAX package's
``models/transformer.py``. Where the reference scans stacked (L, ...)
params with the per-layer window and theta as scanned arrays, the port
keeps one ``nn.ModuleDict`` per layer and loops over them; the pattern is
a pair of host arrays. A cache is a NamedTuple of tensors stacked over the
layers as the reference's; ``block_decode`` writes one layer's slice in
place (a row-indexed write, the same bits as the reference's one-hot
blend).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..configs.base import ModelConfig
from ..kernels import flash_attn as flash_kernel
from ..obs import trace
from . import layers, moe, pspec
from .layers import apply_rope, decode_attention, flash_attention, mlp, \
    qkv_project, rmsnorm

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: Tensor        # (L, B, S_cache, KH, hd)
    v: Tensor
    length: Tensor   # (B,) tokens so far (absolute position), int32


def cache_slots(cfg: ModelConfig, max_len: int) -> int:
    """Slots of a self-attention cache that must hold ``max_len``
    positions: a sliding-window cache rolls, so it never holds more than
    the window."""
    return max_len if cfg.sliding_window <= 0 \
        else min(max_len, cfg.sliding_window)


def init_kv_cache(cfg: ModelConfig, n_layers: int, batch: int,
                  max_len: int, dtype=torch.bfloat16,
                  device="cuda") -> KVCache:
    shape = (n_layers, batch, cache_slots(cfg, max_len), cfg.n_kv_heads,
             cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros(batch, dtype=torch.int32,
                                      device=device))


def _cache_write(k_cache: Tensor, v_cache: Tensor, k_new: Tensor,
                 v_new: Tensor, pos: Tensor) -> None:
    """Write one position (B, 1, KH, hd) at slot ``pos`` (B,) of each
    row, in place; rolling caches pass pos = cur_len % window. A cache on
    a mesh takes the reference's one-hot blend over its slots (an index
    write has no placement rule for a sharded cache)."""
    if isinstance(k_cache, DTensor):
        slots = pspec.lift(torch.arange(k_cache.shape[1],
                                        device=pos.device), k_cache)
        hit = (slots[None, :] == pos[:, None])[:, :, None, None]
        k_cache.copy_(torch.where(hit, k_new, k_cache))
        v_cache.copy_(torch.where(hit, v_new, v_cache))
        return
    rows = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[rows, pos] = k_new[:, 0]
    v_cache[rows, pos] = v_new[:, 0]


# ---------------------------------------------------------------------------
# Transformer blocks
# ---------------------------------------------------------------------------

def init_block(cfg: ModelConfig, dtype=torch.bfloat16, device="cuda",
               cross_attn: bool = False) -> nn.ModuleDict:
    p = {
        "ln1": layers.init_rmsnorm(cfg.d_model, dtype, device),
        "attn": layers.init_attention(cfg.d_model, cfg.n_heads,
                                      cfg.n_kv_heads, cfg.head_dim,
                                      cfg.qkv_bias, dtype, device),
        "ln2": layers.init_rmsnorm(cfg.d_model, dtype, device),
    }
    if cfg.n_experts > 0:
        p["moe"] = moe.init_moe(cfg.d_model, cfg.d_ff, cfg.n_experts, dtype,
                                device)
    else:
        p["mlp"] = layers.init_mlp(cfg.d_model, cfg.d_ff, dtype, device)
    if cross_attn:
        p["ln_x"] = layers.init_rmsnorm(cfg.d_model, dtype, device)
        p["xattn"] = layers.init_attention(cfg.d_model, cfg.n_heads,
                                           cfg.n_kv_heads, cfg.head_dim,
                                           False, dtype, device)
    return nn.ModuleDict(p)


def _ffn(p, cfg: ModelConfig, x: Tensor) -> Tuple[Tensor, Tensor]:
    """The block's feed-forward on its pre-normed input: (out, aux)."""
    if cfg.n_experts > 0:
        return moe.moe_ffn(p["moe"], x, cfg.n_experts_per_tok)
    return mlp(p["mlp"], x), torch.zeros((), dtype=torch.float32,
                                         device=x.device)


def cross_kv(p, cfg: ModelConfig, enc_out: Tensor) -> Tuple[Tensor, Tensor]:
    """The cross-attention K/V (B, S_src, KH, hd) of one decoder block."""
    return tuple(layers.split_heads(enc_out @ p["xattn"][w], cfg.n_kv_heads,
                                    cfg.head_dim) for w in ("wk", "wv"))


def block_forward(p, cfg: ModelConfig, x: Tensor, positions: Tensor,
                  window: int, theta: float, *, causal: bool = True,
                  enc_out: Optional[Tensor] = None, want_kv: bool = False):
    """Full-sequence block (train / prefill). Returns (x, aux, (k, v) or
    None); aux is the MoE load-balancing loss, 0 without experts."""
    x = pspec.constrain(x, "dp", None, None)
    h = rmsnorm(p["ln1"], x, cfg.rms_eps)
    q, k, v = qkv_project(p["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim)
    q = apply_rope(q, positions, theta, cfg.mrope_sections)
    k = apply_rope(k, positions, theta, cfg.mrope_sections)
    o = flash_attention(q, k, v, causal=causal, window=window,
                        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    x = x + o.reshape(x.shape[0], x.shape[1], -1) @ p["attn"]["wo"]
    x = pspec.constrain(x, "dp", None, None)

    if enc_out is not None:
        h = rmsnorm(p["ln_x"], x, cfg.rms_eps)
        qx = layers.split_heads(h @ p["xattn"]["wq"], cfg.n_heads,
                                cfg.head_dim)
        kx, vx = cross_kv(p, cfg, enc_out)
        ox = flash_attention(qx, kx, vx, causal=False, q_chunk=cfg.q_chunk,
                             kv_chunk=cfg.kv_chunk)
        x = x + ox.reshape(x.shape[0], x.shape[1], -1) @ p["xattn"]["wo"]

    m, aux = _ffn(p, cfg, rmsnorm(p["ln2"], x, cfg.rms_eps))
    x = pspec.constrain(x + m, "dp", None, None)
    return x, aux, ((k, v) if want_kv else None)


def attention_mixer(p, cfg: ModelConfig, h: Tensor) -> Tensor:
    """Nemotron-H's attention layer on its pre-normed input h (B, S, D):
    causal GQA over the whole sequence and the output projection, with no
    rotary embedding (the Mamba2 layers carry position) and no MLP. Span
    ``attn.mix`` with the card's time; its ``path`` is "kernel" where
    ``flash_attn.takes_kernel`` holds for q, k and v (for DTensors, their
    local shards, which ``flash_attention`` attends one by one), else
    "eager"."""
    b, s, _ = h.shape
    with trace.span("attn.mix", device_time=True) as sp:
        q, k, v = qkv_project(p, h, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        local = [t.to_local() if isinstance(t, DTensor) else t
                 for t in (q, k, v)]
        kernel = flash_kernel.takes_kernel(*local, causal=True, window=-1,
                                           kv_len=None)
        sp.set(path="kernel" if kernel else "eager")
        o = flash_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                            kv_chunk=cfg.kv_chunk)
        return o.reshape(b, s, -1) @ p["wo"]


def prefill_cache_kv(k_cache: Tensor, v_cache: Tensor, k: Tensor,
                     v: Tensor) -> None:
    """Write full-sequence (B, S, KH, hd) K/V into a zeroed cache of one
    layer, (B, S_cache, KH, hd), in place: at slots 0..S-1 when they fit,
    or, past a sliding window (S > S_cache == window), the last S_cache
    entries rolled so that slot == pos % window. A cache on a mesh has its
    slots split over ``model``: each device fills its own slots from the
    keys it holds whole (a slice write into a sharded dim lands in a
    temporary, not in the cache)."""
    s, n_slots = k.shape[1], k_cache.shape[1]
    fill = functools.partial(_slot_image, s=s, n_slots=n_slots)
    slots = torch.arange(n_slots, device=k.device)
    if not isinstance(k_cache, DTensor):
        k_cache.copy_(fill(k, slots))
        v_cache.copy_(fill(v, slots))
        return
    # the slot indices split as the cache's slot dim; the keys whole there
    at = tuple(k_cache.placements)
    on_slots = tuple(Shard(0) if p == Shard(1) else Replicate() for p in at)
    whole = tuple(Replicate() if p == Shard(1) else p for p in at)
    slots = pspec.lift(slots, k_cache)
    for cache, x in ((k_cache, k), (v_cache, v)):
        cache.copy_(pspec.on_shards(fill, [whole, on_slots], [at], x, slots))


def _slot_image(x: Tensor, slots: Tensor, *, s: int,
                n_slots: int) -> Tensor:
    """The cache slots ``slots`` (global indices) of a cache of
    ``n_slots`` filled from the (B, S, KH, hd) sequence ``x`` of ``s``
    positions: slot j holds position j (j < s), or past a sliding window
    (s > n_slots) the one of the last n_slots positions with
    pos % n_slots == j; a slot with no position is 0."""
    if s > n_slots:
        src = s - n_slots + (slots - s % n_slots) % n_slots
    else:
        src = slots
    img = x.index_select(1, torch.clamp(src, max=s - 1))
    return torch.where((src < s)[None, :, None, None], img,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def block_decode(p, cfg: ModelConfig, x: Tensor, cur_len: Tensor,
                 window: int, theta: float, k_cache: Tensor, v_cache: Tensor,
                 enc_kv: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """One-token block step against the cache, which it writes in place.
    x: (B, 1, D); k_cache, v_cache: (B, S_cache, KH, hd), one layer's.

    A rolling (sliding-window) cache holds only the window, so its slots
    need no mask beyond the valid count; a cache indexed by absolute
    position masks keys at qpos - kpos >= ``window`` (gemma3's local
    layers), as the full-sequence forward does. enc_kv: the precomputed
    cross-attention (kx, vx), (B, S_src, KH, hd)."""
    b = x.shape[0]
    h = rmsnorm(p["ln1"], x, cfg.rms_eps)
    q, k, v = qkv_project(p["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim)
    pos = cur_len[:, None]  # (B, 1) absolute positions
    q = apply_rope(q, pos, theta)
    k = apply_rope(k, pos, theta)
    s_cache = k_cache.shape[1]
    rolling = cfg.sliding_window > 0
    slot = cur_len % s_cache if rolling else cur_len
    _cache_write(k_cache, v_cache, k, v, slot.long())
    eff_len = torch.clamp(cur_len + 1, max=s_cache)
    o = decode_attention(q, k_cache, v_cache, eff_len,
                         window=-1 if rolling else window, q_pos=cur_len)
    x = x + o.reshape(b, 1, -1) @ p["attn"]["wo"]

    if enc_kv is not None:
        kx, vx = enc_kv
        h = rmsnorm(p["ln_x"], x, cfg.rms_eps)
        qx = (h @ p["xattn"]["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
        ox = decode_attention(qx, kx, vx, torch.full(
            (b,), kx.shape[1], dtype=torch.int32, device=x.device))
        x = x + ox.reshape(b, 1, -1) @ p["xattn"]["wo"]

    m, _ = _ffn(p, cfg, rmsnorm(p["ln2"], x, cfg.rms_eps))
    return x + m


# ---------------------------------------------------------------------------
# Attention pattern (per-layer window / theta)
# ---------------------------------------------------------------------------

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
