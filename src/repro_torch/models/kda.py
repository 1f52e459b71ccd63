"""Kimi Delta Attention (KDA), the linear-attention mixer of Kimi Linear
("Kimi Linear: An Expressive, Efficient Attention Architecture", arXiv
2510.26692; ``KimiDeltaAttention`` in the published modeling code): a
gated delta rule whose decay is a rate of its own for each key channel.

On the pre-normed x (B, S, D), with H heads of d channels:

    q, k, v = SiLU(causal conv(x W_q)), ... (width ``conv_width``, no bias);
              q and k L2-normalised per head
    g       = -exp(A_log[h]) softplus((x F_a) F_b + dt_bias)   (B, S, H, d)
    beta    = sigmoid(x W_b)                                   (B, S, H)
    S_t     = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} + beta_t k_t v_t^T
    o_t     = S_t^T q_t d^-1/2
    out     = (RMSNorm_d(o) * sigmoid((x G_a) G_b)) W_o

The norm comes before the gate (Mamba2's gated norm takes it after). The
input projections W_q, W_k, W_v, F_a, G_a and W_b are one matrix
(``w_in``), as Mamba2's are, and the three convs one depthwise conv over
q, k and v's channels (``conv_w``). The recurrence is the chunked form of
``kernels/ref.py::kda_scan_ref``, which has no kernel yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ref
from ..obs import trace
from .layers import const, normal
from .ssm import _causal_conv

Tensor = torch.Tensor

# the L2 norm of q and k: x / sqrt(sum x^2 + eps), as the published kernels
L2_EPS = 1e-6


def init_kda(d_model: int, n_heads: int, head_dim: int, conv_width: int = 4,
             dtype=torch.bfloat16, device="cuda") -> nn.ParameterDict:
    hd = n_heads * head_dim
    f32 = torch.float32
    return nn.ParameterDict({
        # projects to [q, k, v (H d each), F_a (d), G_a (d), beta (H)]
        "w_in": normal((d_model, 3 * hd + 2 * head_dim + n_heads),
                       d_model ** -0.5, dtype, device),
        "conv_w": normal((conv_width, 3 * hd), 0.2, dtype, device),
        "w_f": normal((head_dim, hd), head_dim ** -0.5, dtype, device),
        "w_g": normal((head_dim, hd), head_dim ** -0.5, dtype, device),
        "a_log": const(torch.log(torch.linspace(1.0, 16.0, n_heads,
                                                 dtype=f32)), device),
        "dt_bias": const(torch.zeros(hd, dtype=f32), device),
        "norm_scale": const(torch.ones(head_dim, dtype=dtype), device),
        "w_out": normal((hd, d_model), hd ** -0.5, dtype, device),
    })


def _l2norm(x: Tensor) -> Tensor:
    x = x.float()
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + L2_EPS)


def kda_forward(params, x: Tensor, *, n_heads: int, head_dim: int,
                chunk: int = 64, eps: float = 1e-5) -> Tensor:
    """x: (B, S, D), pre-normed -> (B, S, D) in x's dtype; the output norm
    takes ``eps``. Spans with the card's time: ``kda.in`` (the input
    projection, the conv, the L2 norms, the decays and beta), ``kda.scan``
    (the chunked recurrence; ``path`` "eager") and ``kda.out`` (the norm,
    the gate and the output projection)."""
    b, s, _ = x.shape
    hd = n_heads * head_dim
    heads = (b, s, n_heads, head_dim)
    with trace.span("kda.in", device_time=True):
        proj = x @ params["w_in"]
        qkv = _causal_conv(proj[..., :3 * hd], params["conv_w"])
        q, k, v = (t.reshape(heads) for t in qkv.split(hd, dim=-1))
        q, k = _l2norm(q), _l2norm(k)
        f_a, g_a, beta = proj[..., 3 * hd:].split(
            [head_dim, head_dim, n_heads], dim=-1)
        g = F.softplus((f_a @ params["w_f"]).float() + params["dt_bias"])
        g = -torch.exp(params["a_log"])[:, None] * g.reshape(heads)
        beta = torch.sigmoid(beta.float())
    with trace.span("kda.scan", device_time=True, path="eager"):
        o, _ = ref.kda_scan_ref(q, k, v, g, beta, chunk)
    with trace.span("kda.out", device_time=True):
        var = torch.mean(o * o, dim=-1, keepdim=True)
        o = (o * torch.rsqrt(var + eps)).to(x.dtype) * params["norm_scale"]
        o = o * torch.sigmoid(g_a @ params["w_g"]).reshape(heads)
        return o.reshape(b, s, hd) @ params["w_out"]
