"""Mamba2 SSD (state-space duality) block: the chunked dual form for the
full-sequence forward.

The PyTorch port's counterpart of the JAX package's ``models/ssm.py``.

Recurrence per head (Mamba2, arXiv:2405.21060):
    h_t = exp(dt_t A) h_{t-1} + dt_t * x_t B_t^T        h: (hd, N)
    y_t = C_t h_t + D x_t
Chunked (SSD) evaluation over chunks of length Q:
    intra-chunk: masked (Q x Q) quadratic form, batched matmuls
    inter-chunk: per-chunk states carried by a loop over the chunks
Not yet ported: the final state (``return_state``) and the recurrent
decode step (ROADMAP A8b).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import const, normal

Tensor = torch.Tensor


def init_mamba2(d_model: int, d_state: int, head_dim: int = 64,
                expand: int = 2, conv_width: int = 4, dtype=torch.bfloat16,
                device="cuda") -> nn.ParameterDict:
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    n_groups = 1
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


def _causal_conv(xbc: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (W, C), in the
    input's dtype, then silu rounded to it."""
    width, s = w.shape[0], xbc.shape[1]
    xp = F.pad(xbc, (0, 0, width - 1, 0))
    out = sum(xp[:, i:i + s, :] * w[i] for i in range(width))
    return F.silu(out + b).to(xbc.dtype)


def mamba2_forward(params, x: Tensor, *, d_state: int, head_dim: int = 64,
                   expand: int = 2, chunk: int = 256) -> Tensor:
    """x: (B, S, D) -> y: (B, S, D)."""
    b, s, d_model = x.shape
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    # jnp.split's cut indices [d_inner, 2 d_inner + 2 N] as slices
    proj = x @ params["w_in"]
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:2 * d_inner + 2 * d_state]
    dt = proj[..., 2 * d_inner + 2 * d_state:]
    xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    xs = xbc[..., :d_inner]
    bb = xbc[..., d_inner:d_inner + d_state]
    cc = xbc[..., d_inner + d_state:]
    dt = F.softplus(dt.float() + params["dt_bias"])               # (B,S,H)
    a = -torch.exp(params["a_log"])                                # (H,)

    xh = xs.reshape(b, s, n_heads, head_dim)
    y = _ssd_chunked(xh, dt, a, bb, cc, chunk)
    y = y + params["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(b, s, d_inner).to(x.dtype)
    # gated RMSNorm (mamba2): norm(y * silu(z)), rounded before the scale
    g = y * F.silu(z)
    g32 = g.float()
    var = torch.mean(g32 * g32, dim=-1, keepdim=True)
    g = (g32 * torch.rsqrt(var + 1e-6)).to(x.dtype) * params["norm_scale"]
    return g @ params["w_out"]


def _ssd_chunked(xh: Tensor, dt: Tensor, a: Tensor, bb: Tensor,
                 cc: Tensor, chunk: int) -> Tensor:
    """Chunked SSD. xh: (B,S,H,hd); dt: (B,S,H) float32; a: (H,); bb/cc:
    (B,S,N) (one group). Pads S to whole chunks with dt = 0, so pad rows
    neither decay nor feed the state. Returns y (B,S,H,hd) float32."""
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
    return (y_intra + y_inter).reshape(b, nc * q, h, hd)[:, :s]
