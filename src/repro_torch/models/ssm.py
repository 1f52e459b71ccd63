"""Mamba2 SSD (state-space duality) block: the chunked dual form for the
full-sequence forward (and its final state, for prefill), the O(1)-state
recurrent step for decode.

The PyTorch port's counterpart of the JAX package's ``models/ssm.py``.

Recurrence per head (Mamba2, arXiv:2405.21060):
    h_t = exp(dt_t A) h_{t-1} + dt_t * x_t B_t^T        h: (hd, N)
    y_t = C_t h_t + D x_t
The chunked scan itself is ``ops.ssd_scan``'s: its kernel, or its plain
version ``kernels/ref.py::ssd_scan_ref``; this module runs the plain
version on DTensors' shards.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from ..kernels import ops, ref, ssd_scan as ssd_kernel
from ..obs import trace
from .layers import const, normal
from . import pspec

Tensor = torch.Tensor


def init_mamba2(d_model: int, d_state: int, head_dim: int = 64,
                expand: int = 2, conv_width: int = 4, dtype=torch.bfloat16,
                device="cuda", n_heads: int = 0,
                n_groups: int = 1) -> nn.ParameterDict:
    """A Mamba2 mixer of d_inner = expand x d_model channels, or, given
    ``n_heads``, of n_heads x head_dim (Nemotron-H), with ``n_groups``
    groups of B and C."""
    d_inner = _inner(d_model, head_dim, expand, n_heads)
    n_heads = d_inner // head_dim
    s = d_model ** -0.5
    d_conv = d_inner + 2 * n_groups * d_state
    f32 = torch.float32
    return nn.ParameterDict({
        # projects to [z (d_inner), x (d_inner), B (g*N), C (g*N), dt (H)]
        "w_in": normal((d_model, 2 * d_inner + 2 * n_groups * d_state
                        + n_heads), s, dtype, device),
        "conv_w": normal((conv_width, d_conv), 0.2, dtype, device),
        "conv_b": const(torch.zeros(d_conv, dtype=dtype), device),
        "a_log": const(torch.log(torch.linspace(1.0, 16.0, n_heads,
                                                 dtype=f32)), device),
        "dt_bias": const(torch.zeros(n_heads, dtype=f32), device),
        "d_skip": const(torch.ones(n_heads, dtype=f32), device),
        "norm_scale": const(torch.ones(d_inner, dtype=dtype), device),
        "w_out": normal((d_inner, d_model), d_inner ** -0.5, dtype, device),
    })


def _inner(d_model: int, head_dim: int, expand: int, n_heads: int) -> int:
    """Channels of the mixer: n_heads x head_dim, else expand x d_model."""
    return n_heads * head_dim if n_heads else expand * d_model


class SSMState(NamedTuple):
    conv: Tensor  # (B, conv_width-1, d_conv) rolling pre-conv inputs
    ssm: Tensor   # (B, H, hd, N) recurrent state, float32


def _channels(xbc: Tensor, *others: Tensor) -> list:
    """Placements of a (B, S, C) DTensor and of per-channel tensors
    (``others``, channels last) in the conv: batch over the data axes,
    channels over ``model`` where it divides them."""
    ch = "model" if pspec.divides(xbc, "model", xbc.shape[-1]) else None
    on = functools.partial(pspec.placements_on, xbc)
    return [on(("dp", None, ch))] + [
        on((None,) * (t.dim() - 1) + (ch,), t.shape) for t in others]


def _causal_conv(xbc: Tensor, w: Tensor,
                 b: Optional[Tensor] = None) -> Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (W, C) and bias b
    (C,) if any (Kimi's convs have none), in the input's dtype, then silu
    rounded to it; on DTensors, on each device's shards (independent over
    batch and channels)."""
    if isinstance(xbc, DTensor):
        ins = _channels(xbc, w, b)
        return pspec.on_shards(_causal_conv, ins, [ins[0]], xbc, w, b)
    width, s = w.shape[0], xbc.shape[1]
    xp = F.pad(xbc, (0, 0, width - 1, 0))
    out = sum(xp[:, i:i + s, :] * w[i] for i in range(width))
    return F.silu(out if b is None else out + b).to(xbc.dtype)


def mamba2_forward(params, x: Tensor, *, d_state: int, head_dim: int = 64,
                   expand: int = 2, chunk: int = 256,
                   return_state: bool = False, n_heads: int = 0,
                   n_groups: int = 1, eps: float = 1e-6):
    """x: (B, S, D) -> y: (B, S, D), and with ``return_state`` the final
    ``SSMState``: the last conv_width - 1 pre-conv inputs (front-padded
    with zeros when S is shorter) and the recurrent state. d_inner as
    ``init_mamba2`` sets it; head h reads B and C of group h // (H / G);
    the gated norm is taken per group of d_inner / G channels with
    ``eps``. Spans with the card's time: ``ssm.in`` (the input projection,
    the conv, dt and A), ``ssm.scan`` (the SSD and the skip term; its
    ``path`` is "kernel" where ``ssd_scan.takes_kernel`` holds, else
    "eager") and ``ssm.out`` (the gated norm and the output projection).
    DTensors, and training and float32 models on a card, run the plain
    ``ref.ssd_scan_ref`` here; the rest goes to ``ops.ssd_scan``."""
    b, s, d_model = x.shape
    d_inner = _inner(d_model, head_dim, expand, n_heads)
    n_heads = d_inner // head_dim
    gn = n_groups * d_state
    with trace.span("ssm.in", device_time=True):
        # jnp.split's cut indices [d_inner, 2 d_inner + 2 G N] as slices
        proj = x @ params["w_in"]
        z = proj[..., :d_inner]
        xbc_in = proj[..., d_inner:2 * d_inner + 2 * gn]
        dt = proj[..., 2 * d_inner + 2 * gn:]
        xbc = _causal_conv(xbc_in, params["conv_w"], params["conv_b"])
        xs = xbc[..., :d_inner]
        bb = xbc[..., d_inner:d_inner + gn]
        cc = xbc[..., d_inner + gn:]
        dt = F.softplus(dt.float() + params["dt_bias"])           # (B,S,H)
        a = -torch.exp(params["a_log"])                            # (H,)

    scan = (xs.reshape(b, s, n_heads, head_dim), dt, a, bb, cc,
            params["d_skip"])
    sharded = isinstance(xs, DTensor)
    kernel = not sharded and ssd_kernel.takes_kernel(*scan)
    with trace.span("ssm.scan", device_time=True,
                    path="kernel" if kernel else "eager"):
        if sharded:
            y, st = _ssd(*scan, chunk, n_groups)
        elif kernel or not xs.is_cuda:
            y, st = ops.ssd_scan(*scan, chunk, n_groups, return_state)
        else:
            y, st = ref.ssd_scan_ref(*scan, chunk, n_groups)
        y = y.reshape(b, s, d_inner)
    with trace.span("ssm.out", device_time=True):
        out = _gated_out(params, y, z, x.dtype, n_groups, eps)
    if not return_state:
        return out
    return out, SSMState(conv=_conv_tail(xbc_in, params["conv_w"].shape[0]
                                         - 1), ssm=st)


def _conv_tail(xbc_in: Tensor, tail: int) -> Tensor:
    """The last ``tail`` pre-conv inputs (B, tail, C), front-padded with
    zeros when S is shorter; on DTensors, on each device's shards."""
    if isinstance(xbc_in, DTensor):
        ins = _channels(xbc_in)
        return pspec.on_shards(functools.partial(_conv_tail, tail=tail), ins,
                               ins, xbc_in)
    s = xbc_in.shape[1]
    return F.pad(xbc_in, (0, 0, max(0, tail - s), 0))[:, -tail:, :]


def _gated_out(params, y: Tensor, z: Tensor, dtype, n_groups: int = 1,
               eps: float = 1e-6) -> Tensor:
    """The gated RMSNorm of mamba2, norm(y * silu(z)) over each of
    ``n_groups`` groups of channels, rounded before the scale, then the
    output projection."""
    g = y * F.silu(z)
    g32 = g.float()
    shape = g32.shape
    if n_groups > 1:
        g32 = g32.reshape(*shape[:-1], n_groups, shape[-1] // n_groups)
    var = torch.mean(g32 * g32, dim=-1, keepdim=True)
    g = (g32 * torch.rsqrt(var + eps)).reshape(shape).to(dtype) \
        * params["norm_scale"]
    return g @ params["w_out"]


def _ssd(xh: Tensor, dt: Tensor, a: Tensor, bb: Tensor, cc: Tensor,
         d_skip: Tensor, chunk: int, n_groups: int):
    """``ref.ssd_scan_ref`` on each device's shards of DTensors
    (independent over batch, and over heads where ``model`` divides them);
    one group of B and C."""
    if n_groups > 1:
        raise NotImplementedError("grouped B and C on a mesh")
    b, _, h, hd = xh.shape
    heads = "model" if pspec.divides(xh, "model", h) else None
    on = functools.partial(pspec.placements_on, xh)
    ins = [on(("dp", None, heads, None)), on(("dp", None, heads), dt.shape),
           on((heads,), a.shape), on(("dp", None, None), bb.shape),
           on(("dp", None, None), cc.shape), on((heads,), d_skip.shape)]
    outs = [ins[0], on(("dp", heads, None, None), (b, h, hd, bb.shape[-1]))]
    return pspec.on_shards(functools.partial(ref.ssd_scan_ref, chunk=chunk,
                                             n_groups=1), ins, outs,
                           xh, dt, a, bb, cc, d_skip)


def mamba2_decode_step(params, x: Tensor, state: SSMState, *, d_state: int,
                       head_dim: int = 64, expand: int = 2,
                       eps: float = 1e-6):
    """Single-token recurrent step (one group of B and C). x: (B, 1, D) ->
    (y (B, 1, D), the next ``SSMState``); the recurrent state stays
    float32."""
    b, _, d_model = x.shape
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    proj = x @ params["w_in"]
    z = proj[..., :d_inner]
    xbc_new = proj[..., d_inner:2 * d_inner + 2 * d_state]
    dt = proj[..., 2 * d_inner + 2 * d_state:]
    # rolling conv window: state.conv holds the previous (width-1) inputs;
    # summed tap by tap in the input's dtype as _causal_conv sums them, so
    # that a decode step rounds as the prefill did
    win = torch.cat([state.conv, xbc_new], dim=1)                # (B, W, C)
    w = params["conv_w"]
    out = sum(win[:, i:i + 1, :] * w[i] for i in range(w.shape[0]))
    xbc = F.silu(out + params["conv_b"]).to(x.dtype)
    # the channels split into heads, which a shard of C need not hold
    # whole; the batch as the cache's (over ``data``)
    xbc = pspec.constrain(xbc, "data", None, None)

    xs = xbc[..., :d_inner]
    bvec = xbc[:, 0, d_inner:d_inner + d_state].float()
    cvec = xbc[:, 0, d_inner + d_state:].float()
    dt = F.softplus(dt.float() + params["dt_bias"])[:, 0]        # (B, H)
    a = -torch.exp(params["a_log"])
    xhh = xs.reshape(b, n_heads, head_dim).float()

    dec = torch.exp(dt * a)
    upd = torch.einsum("bh,bhd,bn->bhdn", dt, xhh, bvec)
    new_ssm = pspec.constrain(state.ssm * dec[..., None, None] + upd,
                              "data", "model", None, None)
    y = torch.einsum("bhdn,bn->bhd", new_ssm, cvec) \
        + params["d_skip"][None, :, None] * xhh
    y = y.reshape(b, 1, d_inner).to(x.dtype)
    return _gated_out(params, y, z, x.dtype, eps=eps), \
        SSMState(conv=win[:, 1:], ssm=new_ssm)
