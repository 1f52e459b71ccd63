"""Mamba2 SSD (state-space duality) block: the chunked dual form for the
full-sequence forward (and its final state, for prefill), the O(1)-state
recurrent step for decode.

The PyTorch port's counterpart of the JAX package's ``models/ssm.py``.

Recurrence per head (Mamba2, arXiv:2405.21060):
    h_t = exp(dt_t A) h_{t-1} + dt_t * x_t B_t^T        h: (hd, N)
    y_t = C_t h_t + D x_t
Chunked (SSD) evaluation over chunks of length Q:
    intra-chunk: masked (Q x Q) quadratic form, batched matmuls
    inter-chunk: per-chunk states carried by a loop over the chunks
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from ..kernels import ops
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


def _causal_conv(xbc: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (W, C), in the
    input's dtype, then silu rounded to it; on DTensors, on each device's
    shards (independent over batch and channels)."""
    if isinstance(xbc, DTensor):
        ins = _channels(xbc, w, b)
        return pspec.on_shards(_causal_conv, ins, [ins[0]], xbc, w, b)
    width, s = w.shape[0], xbc.shape[1]
    xp = F.pad(xbc, (0, 0, width - 1, 0))
    out = sum(xp[:, i:i + s, :] * w[i] for i in range(width))
    return F.silu(out + b).to(xbc.dtype)


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
    ``path`` is "kernel" where ``_takes_kernel`` sends it to
    ``ops.ssd_scan``, else "eager") and ``ssm.out`` (the gated norm and
    the output projection)."""
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

    xh = xs.reshape(b, s, n_heads, head_dim)
    kernel = _takes_kernel(xh, dt, a, bb, cc, params["d_skip"])
    with trace.span("ssm.scan", device_time=True,
                    path="kernel" if kernel else "eager"):
        if kernel:
            y, st = ops.ssd_scan(xh, dt, a, bb, cc, params["d_skip"], chunk,
                                 n_groups, return_state)
        else:
            y, st = ssd_eager(xh, dt, a, bb, cc, params["d_skip"], chunk,
                              n_groups)
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


def ssd_eager(xh: Tensor, dt: Tensor, a: Tensor, bb: Tensor, cc: Tensor,
              d_skip: Tensor, chunk: int, n_groups: int):
    """The SSD in eager operations (``_ssd_groups``), then y + D x rounded
    to xh's dtype: (y (B, S, H, hd), the final state (B, H, hd, N)
    float32). The plain version of ``ops.ssd_scan``."""
    y, st = _ssd_groups(xh, dt, a, bb, cc, chunk, n_groups)
    y = y + d_skip[None, None, :, None] * xh.float()
    return y.to(xh.dtype), st


def _takes_kernel(xh: Tensor, *others: Tensor) -> bool:
    """The SSD runs in ``ops.ssd_scan``'s kernel for a bfloat16 tensor on a
    card that is no DTensor and needs no gradient (grad mode off, or no
    input requiring one); training, the mesh, float32 models and the CPU
    keep the eager form."""
    return (xh.is_cuda and xh.dtype == torch.bfloat16
            and not isinstance(xh, DTensor)
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in (xh, *others))))


def _ssd_groups(xh: Tensor, dt: Tensor, a: Tensor, bb: Tensor, cc: Tensor,
                chunk: int, n_groups: int):
    """``_ssd`` with B and C in ``n_groups`` groups (bb, cc: (B, S, G N));
    one group keeps ``_ssd``'s operations."""
    if n_groups == 1:
        return _ssd(xh, dt, a, bb, cc, chunk)
    if isinstance(xh, DTensor):
        raise NotImplementedError("grouped B and C on a mesh")
    b, s = bb.shape[:2]
    return _ssd_chunked_grouped(xh, dt, a, bb.reshape(b, s, n_groups, -1),
                                cc.reshape(b, s, n_groups, -1), chunk)


def _ssd(xh: Tensor, dt: Tensor, a: Tensor, bb: Tensor, cc: Tensor,
         chunk: int):
    """``_ssd_chunked``; on DTensors, on each device's shards (independent
    over batch, and over heads where ``model`` divides them)."""
    if not isinstance(xh, DTensor):
        return _ssd_chunked(xh, dt, a, bb, cc, chunk)
    b, _, h, hd = xh.shape
    heads = "model" if pspec.divides(xh, "model", h) else None
    on = functools.partial(pspec.placements_on, xh)
    ins = [on(("dp", None, heads, None)), on(("dp", None, heads), dt.shape),
           on((heads,), a.shape), on(("dp", None, None), bb.shape),
           on(("dp", None, None), cc.shape)]
    outs = [ins[0], on(("dp", heads, None, None), (b, h, hd, bb.shape[-1]))]
    return pspec.on_shards(functools.partial(_ssd_chunked, chunk=chunk), ins,
                           outs, xh, dt, a, bb, cc)


def _ssd_chunked(xh: Tensor, dt: Tensor, a: Tensor, bb: Tensor,
                 cc: Tensor, chunk: int) -> Tensor:
    """Chunked SSD. xh: (B,S,H,hd); dt: (B,S,H) float32; a: (H,); bb/cc:
    (B,S,N) (one group). Pads S to whole chunks with dt = 0, so pad rows
    neither decay nor feed the state. Returns (y (B,S,H,hd) float32, the
    final state (B,H,hd,N) float32)."""
    b, s, h, hd = xh.shape
    n = bb.shape[-1]
    q = chunk
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bb = F.pad(bb, (0, 0, 0, pad))
        cc = F.pad(cc, (0, 0, 0, pad))
    xc = xh.reshape(b, nc, q, h, hd).float()
    dtc = dt.reshape(b, nc, q, h)
    bc = bb.reshape(b, nc, q, n).float()
    ccx = cc.reshape(b, nc, q, n).float()

    la = dtc * a                     # (B,nc,q,H) log decay per step
    cum = torch.cumsum(la, dim=2)    # L_t
    total = cum[:, :, -1:, :]        # L_Q

    # intra-chunk: y[t] = sum_{s<=t} C_t.B_s exp(L_t - L_s) dt_s x_s
    idx = torch.arange(q, device=xh.device)
    causal = idx[:, None] >= idx[None, :]
    dec = torch.exp(torch.clamp(cum[:, :, :, None, :] - cum[:, :, None, :, :],
                                -60.0, 0.0))                  # (B,nc,q,q,H)
    cb = torch.einsum("bcqn,bcsn->bcqs", ccx, bc)             # (B,nc,q,q)
    w_ = cb[..., None] * dec * dtc[:, :, None, :, :] \
        * causal[None, None, :, :, None]
    y_intra = torch.einsum("bcqsh,bcshd->bcqhd", w_, xc)

    # chunk-level input state: sum_s exp(L_Q - L_s) dt_s x_s B_s^T
    decq = torch.exp(torch.clamp(total - cum, -60.0, 0.0))    # (B,nc,q,H)
    sin = torch.einsum("bcqh,bcqhd,bcqn->bchdn", decq * dtc, xc, bc)

    # chunk states: st_c = exp(L_Q_c) st_{c-1} + sin_c; chunk c reads the
    # state coming IN to it
    chunk_decay = torch.exp(torch.clamp(total[:, :, 0, :], min=-60.0))
    st = torch.zeros(b, h, hd, n, dtype=torch.float32, device=xh.device)
    st_in = []
    for c in range(nc):
        st_in.append(st)
        st = st * chunk_decay[:, c, :, None, None] + sin[:, c]
    st_in = torch.stack(st_in, dim=1)                         # (B,nc,H,hd,N)

    # inter-chunk: y[t] += C_t (exp(L_t) st_in)
    y_inter = torch.einsum("bcqn,bcqh,bchdn->bcqhd", ccx,
                           torch.exp(torch.clamp(cum, -60.0, 0.0)), st_in)
    return (y_intra + y_inter).reshape(b, nc * q, h, hd)[:, :s], st


def _ssd_chunked_grouped(xh: Tensor, dt: Tensor, a: Tensor, bb: Tensor,
                         cc: Tensor, chunk: int):
    """``_ssd_chunked`` with bb, cc (B, S, G, N): head h reads group
    h // (H / G), so the heads are laid out (G, H / G) beside their
    group's B and C, and every group runs in the same passes."""
    b, s, h, hd = xh.shape
    g, n = bb.shape[2:]
    q = chunk
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bb = F.pad(bb, (0, 0, 0, 0, 0, pad))
        cc = F.pad(cc, (0, 0, 0, 0, 0, pad))
    xc = xh.reshape(b, nc, q, g, h // g, hd).float()
    dtc = dt.reshape(b, nc, q, g, h // g)
    bc = bb.reshape(b, nc, q, g, n).float()
    ccx = cc.reshape(b, nc, q, g, n).float()

    cum = torch.cumsum(dtc * a.reshape(g, h // g), dim=2)   # (B,nc,q,G,J)
    total = cum[:, :, -1:]
    idx = torch.arange(q, device=xh.device)
    causal = (idx[:, None] >= idx[None, :])[:, :, None, None]
    dec = torch.exp(torch.clamp(cum[:, :, :, None] - cum[:, :, None],
                                -60.0, 0.0))             # (B,nc,q,q,G,J)
    cb = torch.einsum("bcqgn,bcsgn->bcqsg", ccx, bc)
    w_ = cb[..., None] * dec * dtc[:, :, None] * causal
    y_intra = torch.einsum("bcqsgj,bcsgjd->bcqgjd", w_, xc)

    decq = torch.exp(torch.clamp(total - cum, -60.0, 0.0))
    sin = torch.einsum("bcqgj,bcqgjd,bcqgn->bcgjdn", decq * dtc, xc, bc)
    chunk_decay = torch.exp(torch.clamp(total[:, :, 0], min=-60.0))
    st = torch.zeros(b, g, h // g, hd, n, dtype=torch.float32,
                     device=xh.device)
    st_in = []
    for c in range(nc):
        st_in.append(st)
        st = st * chunk_decay[:, c, :, :, None, None] + sin[:, c]
    st_in = torch.stack(st_in, dim=1)                   # (B,nc,G,J,hd,N)
    y_inter = torch.einsum("bcqgn,bcqgj,bcgjdn->bcqgjd", ccx,
                           torch.exp(torch.clamp(cum, -60.0, 0.0)), st_in)
    y = (y_intra + y_inter).reshape(b, nc * q, h, hd)[:, :s]
    return y, st.reshape(b, h, hd, n)


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
