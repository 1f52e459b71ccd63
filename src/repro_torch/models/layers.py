"""Shared transformer layers: RMSNorm, RoPE (incl. M-RoPE sections),
grouped-query attention with optional QKV bias / sliding window / chunked
streaming softmax, single-position decode attention, SwiGLU MLP.

The PyTorch port's counterpart of the JAX package's ``models/layers.py``.
Parameters live in ``nn.ParameterDict``s under the reference's names
(``init_*`` builds them), and every layer is a function of such a mapping
and tensors, so the reference's param tree carries across by name
(``convert.model_params_from_jax``). Compute dtype is the input dtype
(bfloat16 in production), accumulation float32 where the reference's is:
each function rounds back to the model dtype where the reference does.

``flash_attention`` is the reference's streaming-softmax algorithm in plain
PyTorch, blocked by ``q_chunk`` and ``kv_chunk`` as the reference is; the
reference has no hand kernel here either. ``flash_attention``'s
``q_offset``, which no caller of the reference passes, is left out.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


def normal(shape, scale: float, dtype, device) -> nn.Parameter:
    """An unfilled parameter that ``Model.reset_parameters`` draws as
    ``scale`` x N(0, 1) (its ``init_scale``); on the meta device it only
    describes a shape."""
    p = nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
    p.init_scale = scale
    return p


def const(value: Tensor, device) -> nn.Parameter:
    """A parameter filled with ``value``, which ``Model.reset_parameters``
    restores (its ``init_value``)."""
    p = nn.Parameter(value.to(device, copy=True))
    p.init_value = value
    return p


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype=torch.float32,
                 device="cuda") -> nn.ParameterDict:
    return nn.ParameterDict(
        {"scale": const(torch.ones(d, dtype=dtype), device)})


def rmsnorm(params: Mapping[str, Tensor], x: Tensor,
            eps: float = 1e-6) -> Tensor:
    """Normalised in float32, rounded to ``x``'s dtype, then scaled."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * params["scale"]


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device="cpu") -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float = 1e4,
               sections: Sequence[int] = ()) -> Tensor:
    """x: (B, S, H, hd); positions: (B, S), or (3, B, S) for M-RoPE.
    Half-split rotation: the first hd/2 channels pair with the last hd/2,
    in float32.

    M-RoPE (Qwen2-VL): the hd/2 rotary frequency channels are split into
    ``sections`` (t, h, w) groups in order; group g rotates by
    positions[g]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    if positions.dim() == 2:
        ang = positions[..., None].float() * freqs      # (B, S, hd/2)
    else:
        if not sections:
            raise ValueError("3-D positions need mrope sections")
        bounds = torch.cumsum(torch.tensor(tuple(sections)), 0)
        group = torch.searchsorted(bounds, torch.arange(freqs.shape[0]),
                                   right=True)          # (hd/2,)
        pos_g = positions[group.to(positions.device)]   # (hd/2, B, S)
        ang = torch.movedim(pos_g, 0, -1).float() * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, qkv_bias: bool, dtype=torch.bfloat16,
                   device="cuda") -> nn.ParameterDict:
    s = d_model ** -0.5
    p = {
        "wq": normal((d_model, n_heads * head_dim), s, dtype, device),
        "wk": normal((d_model, n_kv_heads * head_dim), s, dtype, device),
        "wv": normal((d_model, n_kv_heads * head_dim), s, dtype, device),
        "wo": normal((n_heads * head_dim, d_model), s, dtype, device),
    }
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv_heads),
                            ("bv", n_kv_heads)):
            p[name] = const(torch.zeros(width * head_dim, dtype=dtype),
                            device)
    return nn.ParameterDict(p)


def qkv_project(params: Mapping[str, Tensor], x: Tensor, n_heads: int,
                n_kv_heads: int, head_dim: int):
    b, s, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return (q.reshape(b, s, n_heads, head_dim),
            k.reshape(b, s, n_kv_heads, head_dim),
            v.reshape(b, s, n_kv_heads, head_dim))


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = -1, q_chunk: int = 1024,
                    kv_chunk: int = 1024,
                    kv_len: Optional[Tensor] = None) -> Tensor:
    """Chunked streaming-softmax attention, in float32.

    q: (B, Sq, H, hd); k, v: (B, Skv, KH, hd) with H = KH * G (GQA: query
    head h reads KV head h // G). window: -1/0 => full; w > 0 => keys with
    qpos - kpos >= w are masked (sliding window). kv_len: optional (B,)
    valid KV length. Masked scores are -1e30 and the output divides by
    max(l, 1e-30), as the reference's. Blocks start at multiples of the
    chunks, as the reference's do; the last block of each axis is ragged
    where the reference pads it (its padded rows are masked or dropped, so
    no value changes), and a chunk longer than the sequence is one block.
    Memory: O(q_chunk * kv_chunk) scores per step instead of O(Sq * Skv).
    """
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = hd ** -0.5
    dev = q.device
    qf = q.float().reshape(b, sq, kh, g, hd)
    kf, vf = k.float(), v.float()
    limit = (torch.full((1, 1), skv, device=dev) if kv_len is None
             else kv_len.to(dev)[:, None])                  # (B or 1, 1)
    out = torch.empty(b, sq, kh, g, hd, dtype=torch.float32, device=dev)
    for q0 in range(0, sq, q_chunk):
        qi = qf[:, q0:q0 + q_chunk]
        qpos = torch.arange(q0, q0 + qi.shape[1], device=dev)
        m = torch.full(qi.shape[:-1], -torch.inf, device=dev)
        l = torch.zeros(qi.shape[:-1], device=dev)
        acc = torch.zeros(qi.shape, device=dev)
        for k0 in range(0, skv, kv_chunk):
            kj, vj = kf[:, k0:k0 + kv_chunk], vf[:, k0:k0 + kv_chunk]
            kpos = torch.arange(k0, k0 + kj.shape[1], device=dev)
            s_ = torch.einsum("bqkgd,bckd->bqkgc", qi, kj) * scale
            mask = (kpos[None, :] < limit)[:, None, None, None, :]
            if causal:
                cm = kpos[None, :] <= qpos[:, None]           # (cq, ck)
                if window > 0:
                    cm = cm & (qpos[:, None] - kpos[None, :] < window)
                mask = mask & cm[None, :, None, None, :]
            s_ = torch.where(mask, s_, -1e30)
            m_new = torch.maximum(m, s_.amax(dim=-1))
            p = torch.exp(s_ - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgc,bckd->bqkgd", p, vj)
            m = m_new
        out[:, q0:q0 + q_chunk] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, sq, h, hd).to(q.dtype)


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     cur_len: Tensor, window: int = -1,
                     q_pos: Optional[Tensor] = None) -> Tensor:
    """Single-position attention against a (B, S_max, KH, hd) cache, with
    a float32 softmax.

    q: (B, 1, H, hd). cur_len: (B,) number of valid cache entries (the new
    token's K/V already written). Products of the cache's values are exact
    in float32 and summed there, as the reference's float32 accumulation
    of bfloat16 operands. window > 0 also masks the slots with
    q_pos - slot >= window, for a cache whose slot is the key's absolute
    position; q_pos: (B,) the query's position. Masked scores are -1e30."""
    b, _, h, hd = q.shape
    kh = k_cache.shape[2]
    qg = q.reshape(b, kh, h // kh, hd).float()
    s_ = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    s_ = s_ * hd ** -0.5
    pos = torch.arange(k_cache.shape[1], device=q.device)
    mask = pos[None, :] < cur_len[:, None]                 # (B, S)
    if window > 0:
        mask = mask & (q_pos[:, None] - pos[None, :] < window)
    s_ = torch.where(mask[:, None, None, :], s_, -1e30)
    p = torch.softmax(s_, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def init_mlp(d_model: int, d_ff: int, dtype=torch.bfloat16,
             device="cuda") -> nn.ParameterDict:
    s = d_model ** -0.5
    return nn.ParameterDict({
        "w_gate": normal((d_model, d_ff), s, dtype, device),
        "w_up": normal((d_model, d_ff), s, dtype, device),
        "w_down": normal((d_ff, d_model), d_ff ** -0.5, dtype, device),
    })


def mlp(params: Mapping[str, Tensor], x: Tensor) -> Tensor:
    return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) \
        @ params["w_down"]
