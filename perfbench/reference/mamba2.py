"""Plain PyTorch reference of the Mamba2 featurizer: token embedding, then
per layer an RMSNorm, the input projection to (z, x, B, C, dt), the
depthwise causal conv with SiLU over (x, B, C), the SSD recurrence in its
quadratic (attention-like) form over the whole sequence, the D skip, the
gated RMSNorm and the output projection, added to the residual; then the
final RMSNorm, the mean over every position and the Cox head.

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = C_t h_t + D x_t
    y_t = sum_{s <= t} (C_t . B_s) exp(L_t - L_s) dt_s x_s + D x_t,
    L_t = sum_{r <= t} dt_r A

It computes in float32 with TF32 off, from the benchmark's own weights
(``data/mamba2_weights.py``) upcast to float32, in blocks of sequences;
``matmul`` may be replaced (the control computes its projections in
float8). Imports nothing of the program. The RMSNorm epsilon
(``rms_norm_eps``, 1e-6 as the program runs) and one group of B and C are
the configuration's."""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _rms(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * scale


def _ssd(xh: Tensor, dt: Tensor, a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """xh (B,S,H,P), dt (B,S,H), a (H,), b and c (B,S,N) -> y (B,S,H,P)."""
    s = xh.shape[1]
    lcum = torch.cumsum(dt * a, 1)                              # (B,S,H)
    diff = lcum[:, :, None, :] - lcum[:, None, :, :]            # (B,T,S,H)
    causal = torch.ones(s, s, dtype=torch.bool, device=xh.device).tril()
    decay = torch.where(causal[None, :, :, None],
                        torch.exp(torch.clamp(diff, max=0.0)), 0.0)
    cb = torch.einsum("btn,bsn->bts", c, b)
    m = cb[..., None] * decay * dt[:, None, :, :]               # (B,T,S,H)
    return torch.einsum("btsh,bshp->bthp", m, xh)


def forward(weights: Dict[str, Tensor], tokens: Tensor, cfg: dict,
            matmul: Callable[[Tensor, Tensor], Tensor] = torch.matmul):
    """(pooled features (B, D), risk (B,)) of ``tokens`` (B, S)."""
    w = lambda k: weights[k].float()
    d = int(cfg["d_model"])
    di = int(cfg["expand"]) * d
    n = int(cfg["d_state"])
    hd = int(cfg["headdim"])
    h = di // hd
    width = int(cfg["d_conv"])
    eps = float(cfg["rms_norm_eps"])
    x = w("embed")[tokens.long()]
    bsz, s, _ = x.shape
    for i in range(int(cfg["n_layer"])):
        p = f"layers.{i}."
        u = _rms(x, w(p + "ln.scale"), eps)
        proj = matmul(u, w(p + "mamba.w_in"))
        z = proj[..., :di]
        xbc = proj[..., di:2 * di + 2 * n]
        dt = proj[..., 2 * di + 2 * n:]
        cw = w(p + "mamba.conv_w")
        xp = F.pad(xbc, (0, 0, width - 1, 0))
        conv = sum(xp[:, k:k + s, :] * cw[k] for k in range(width))
        xbc = F.silu(conv + w(p + "mamba.conv_b"))
        xs, bb, cc = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
        dt = F.softplus(dt + w(p + "mamba.dt_bias"))
        a = -torch.exp(w(p + "mamba.a_log"))
        xh = xs.reshape(bsz, s, h, hd)
        y = _ssd(xh, dt, a, bb, cc) + w(p + "mamba.d_skip")[:, None] * xh
        g = _rms(y.reshape(bsz, s, di) * F.silu(z),
                 w(p + "mamba.norm_scale"), eps)
        x = x + matmul(g, w(p + "mamba.w_out"))
    pooled = _rms(x, w("final_norm.scale"), eps).mean(1)
    risk = pooled @ w("cox_head.w")[:, 0] + w("cox_head.b")
    return pooled, risk


def fp8_matmul(a: Tensor, b: Tensor) -> Tensor:
    """a @ b with both operands rounded to float8 e4m3, each scaled by its
    largest magnitude, and the product taken in float32: the control's
    projections."""
    def q(t):
        scale = torch.clamp(t.abs().max(), min=1e-12) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).float() * scale
    return q(a) @ q(b)


def features(weights: Dict[str, Tensor], tokens: Tensor, cfg: dict,
             block: int = 8, matmul=torch.matmul):
    """``forward`` in blocks of ``block`` sequences with TF32 off."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        outs = [forward(weights, tokens[i:i + block], cfg, matmul)
                for i in range(0, tokens.shape[0], block)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))
