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

``flash_attention`` routes; the work lives in the kernels layer. Its plain
version, the reference's streaming-softmax algorithm blocked by ``q_chunk``
and ``kv_chunk`` as the reference is, is ``kernels/ref.py::
flash_attention_ref``; causal bfloat16 inference on a card runs the hand
kernel ``kernels/csrc/flash_attn.cu`` through ``kernels/flash_attn.py``
(the reference's attention is plain ``jnp``). ``flash_attention``'s
``q_offset``, which no caller of the reference passes, is left out.
"""
from __future__ import annotations

import functools
from typing import Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from ..kernels import flash_attn as flash_kernel
from ..kernels import ops, ref
from . import pspec

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
    freqs = pspec.lift(rope_freqs(x.shape[-1], theta, x.device), x)
    positions = pspec.lift(positions, x)
    if positions.dim() == 2:
        ang = positions[..., None].float() * freqs      # (B, S, hd/2)
    else:
        if not sections:
            raise ValueError("3-D positions need mrope sections")
        bounds = torch.cumsum(torch.tensor(tuple(sections)), 0)
        group = torch.searchsorted(bounds, torch.arange(freqs.shape[0]),
                                   right=True)          # (hd/2,)
        pos_g = positions[pspec.lift(group.to(x.device), x)]  # (hd/2, B, S)
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


def init_mla(d_model: int, n_heads: int, kv_lora_rank: int, qk_nope: int,
             qk_rope: int, v_dim: int, dtype=torch.bfloat16,
             device="cuda") -> nn.ParameterDict:
    """Latent attention's weights (DeepSeek-V2's MLA with no query
    compression): the query projection, the shared compressed KV and key
    part (``kv_a_proj_with_mqa``), its norm, the KV decompression
    (``kv_b_proj``) and the output projection."""
    s = d_model ** -0.5
    vo = n_heads * v_dim
    return nn.ParameterDict({
        "wq": normal((d_model, n_heads * (qk_nope + qk_rope)), s, dtype,
                     device),
        "wkv_a": normal((d_model, kv_lora_rank + qk_rope), s, dtype, device),
        "kv_norm": const(torch.ones(kv_lora_rank, dtype=dtype), device),
        "wkv_b": normal((kv_lora_rank, n_heads * (qk_nope + v_dim)),
                        kv_lora_rank ** -0.5, dtype, device),
        "wo": normal((vo, d_model), vo ** -0.5, dtype, device),
    })


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
    return (split_heads(q, n_heads, head_dim),
            split_heads(k, n_kv_heads, head_dim),
            split_heads(v, n_kv_heads, head_dim))


def split_heads(t: Tensor, n: int, head_dim: int) -> Tensor:
    """(B, S, n * hd) -> (B, S, n, hd); on a mesh the projection's columns
    stay over ``model`` only where ``model`` divides the heads."""
    b, s, _ = t.shape
    heads = "model" if pspec.divides(t, "model", n) else None
    return pspec.constrain(t, "dp", None, heads).reshape(b, s, n, head_dim)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = -1, q_chunk: int = 1024,
                    kv_chunk: int = 1024,
                    kv_len: Optional[Tensor] = None) -> Tensor:
    """Attention of q (B, Sq, H, hd) over k (B, Skv, KH, hd) and v (B, Skv,
    KH, dv), H = KH * G (GQA: query head h reads KV head h // G), in q's
    dtype, (B, Sq, H, dv). window: -1/0
    => full; w > 0 => keys with qpos - kpos >= w are masked (sliding
    window). kv_len: optional (B,) valid KV length.

    Decided once, by ``flash_attn.takes_kernel``: causal bfloat16 attention
    on a card with no window, no ``kv_len`` and no gradient, whose (q and
    k, v) head dims are an instantiated pair (``flash_attn.HEAD_DIMS``:
    (64, 64), (128, 128) and latent attention's (192, 128)), goes to the
    kernel (``ops.flash_attn``); everything else runs the float32 streaming
    softmax ``ref.flash_attention_ref``, blocked by ``q_chunk`` and
    ``kv_chunk`` as the reference is.
    """
    if isinstance(q, DTensor):
        # independent over batch and KV heads: each device runs this body
        # on its shards as plain tensors
        if kv_len is not None:
            raise ValueError("kv_len is for plain tensors")
        # heads over ``model`` only where it divides the KV heads: the
        # query heads split into (KH, G) groups, which a shard of H cannot
        # hold whole where KH is smaller than the axis
        heads = "model" if pspec.divides(q, "model", k.shape[2]) else None
        ins = [pspec.placements_on(t, ("dp", None, heads, None))
               for t in (q, k, v)]
        return pspec.on_shards(functools.partial(
            flash_attention, causal=causal, window=window, q_chunk=q_chunk,
            kv_chunk=kv_chunk), ins, [ins[0]], q, k, v)
    if flash_kernel.takes_kernel(q, k, v, causal=causal, window=window,
                                 kv_len=kv_len):
        return ops.flash_attn(q, k, v)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_chunk=q_chunk, kv_chunk=kv_chunk,
                                   kv_len=kv_len)


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
    # on the cache's layout: its batch over ``data`` (not ``pod``: the
    # reference's ``cache_spec``), its slots over ``model`` (flash-decode),
    # so the heads not
    q = pspec.constrain(q, "data", None, None, None)
    qg = q.reshape(b, kh, h // kh, hd).float()
    s_ = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    s_ = s_ * hd ** -0.5
    pos = pspec.lift(torch.arange(k_cache.shape[1], device=q.device), q)
    mask = pos[None, :] < pspec.lift(cur_len, q)[:, None]  # (B, S)
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
