"""Plain PyTorch reference of the NVIDIA Nemotron-H featurizer
(``model_type`` ``nemotron_h``, NVIDIA-Nemotron-3-Nano-30B-A3B): token
embedding, then one pre-norm residual layer a character of
``hybrid_override_pattern``,

    x <- x + mixer(RMSNorm(x)),   mixer: M Mamba2, E sparse experts, * GQA

then the final RMSNorm, the mean over every position and a Cox head.

- M: the input projection to (z, x, B, C, dt), the depthwise causal conv
  with its bias and SiLU over (x, B, C), dt = softplus(dt + dt_bias), the
  SSD recurrence in its quadratic (attention-like) form, where head h
  reads B and C of group h // (H / G),

      y_t = sum_{s <= t} (C_t . B_s) exp(L_t - L_s) dt_s x_s + D x_t,
      L_t = sum_{r <= t} dt_r A,   A = -exp(A_log),

  the gated RMSNorm norm(y * silu(z)) over each group of d_inner / G
  channels, and the output projection.
- E: sigmoid scores of the router; the top ``num_experts_per_tok`` of
  score + ``e_score_correction_bias`` choose; the chosen plain scores,
  over their sum (``norm_topk_prob``), times ``routed_scaling_factor``,
  weigh each expert's relu(x W_up)^2 W_down; plus the shared expert's
  relu(x S_up)^2 S_down on every token.
- *: causal GQA, query head h reading KV head h // (H / KH), softmax of
  q.k / sqrt(head_dim), and the output projection.

Departures from the published model: the attention layers apply no
rotary embedding (the published ``modeling_nemotron_h.py`` reads none,
though ``config.json`` lists ``rope_theta``; position comes from the
Mamba2 layers); the router's group-limited choice is left out, as
``n_group`` = ``topk_group`` = 1 makes it the plain top-k; the LM head
is not computed (the featurizer reads the final hidden state); the Cox
head on the pooled features is the benchmark's, not the model's; the
SSD is its quadratic form, equal in exact arithmetic to the published
chunked scan.

It computes in float32 with TF32 off, from weights given by the
program's parameter names (``weights(name)``, upcast to float32 here),
one layer at a time over every sequence, so that a caller can draw each
layer's weights after the last layer's are dropped. ``matmul`` may be
replaced for the projections, the experts and the shared expert (the
control computes them in float8); the router stays float32.

A top-k choice is discrete: where another computation's rounding moves a
token's k-th and (k+1)-th biased scores past each other, its output
differs by a whole expert. So the reference can take the choices
(``routes``, each expert layer's (T, k) experts, T = B S in batch order)
from the computation it checks and recompute the rest at them, weights
included; it then reports how far those choices stand below its own:
``route_gap``, the largest over tokens and layers of its own k-th
biased score less the lowest biased score among the given choices (0
where they are its own top k, infinite where one token repeats an
expert). Imports nothing of the program."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
# heads of the quadratic SSD and of attention computed at once: bounds the
# (heads, S, S) float32 temporaries
HEAD_BLOCK = 8


def _rms(x: Tensor, scale: Tensor, eps: float, groups: int = 1) -> Tensor:
    shape = x.shape
    x = x.reshape(*shape[:-1], groups, shape[-1] // groups)
    x = x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps)
    return x.reshape(shape) * scale


def _ssd(xh: Tensor, dt: Tensor, a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """One sequence: xh (S,H,P), dt (S,H), a (H,), b and c (S,G,N) -> y
    (S,H,P)."""
    s, h, _ = xh.shape
    per_group = h // b.shape[1]
    lcum = torch.cumsum(dt * a, 0)                               # (S,H)
    causal = torch.ones(s, s, dtype=torch.bool, device=xh.device).tril()
    y = torch.empty_like(xh)
    for h0 in range(0, h, HEAD_BLOCK):
        hs = slice(h0, min(h0 + HEAD_BLOCK, h))
        group = torch.arange(hs.start, hs.stop,
                             device=xh.device) // per_group
        cb = torch.einsum("thn,shn->hts", c[:, group], b[:, group])
        diff = lcum[:, None, hs] - lcum[None, :, hs]   # (T,S,h): L_t - L_s
        decay = torch.where(causal[:, :, None],
                            torch.exp(torch.clamp(diff, max=0.0)), 0.0)
        m = cb * decay.permute(2, 0, 1) * dt[:, hs].T[:, None, :]
        y[:, hs] = torch.einsum("hts,shp->thp", m, xh[:, hs])
    return y


def _mamba(w, p: str, u: Tensor, cfg: dict, matmul) -> Tensor:
    """u (S, D), normed -> the mixer's output (S, D)."""
    h, hd = int(cfg["mamba_num_heads"]), int(cfg["mamba_head_dim"])
    g, n = int(cfg["n_groups"]), int(cfg["ssm_state_size"])
    width = int(cfg["conv_kernel"])
    di, gn = h * hd, g * n
    s = u.shape[0]
    proj = matmul(u, w(p + "mamba.w_in"))
    z, xbc, dt = proj[:, :di], proj[:, di:2 * di + 2 * gn], proj[:, -h:]
    cw = w(p + "mamba.conv_w")
    xp = F.pad(xbc, (0, 0, width - 1, 0))
    xbc = F.silu(sum(xp[k:k + s] * cw[k] for k in range(width))
                 + w(p + "mamba.conv_b"))
    xs = xbc[:, :di].reshape(s, h, hd)
    bb = xbc[:, di:di + gn].reshape(s, g, n)
    cc = xbc[:, di + gn:].reshape(s, g, n)
    dt = F.softplus(dt + w(p + "mamba.dt_bias"))
    a = -torch.exp(w(p + "mamba.a_log"))
    y = _ssd(xs, dt, a, bb, cc) + w(p + "mamba.d_skip")[:, None] * xs
    gated = _rms(y.reshape(s, di) * F.silu(z), w(p + "mamba.norm_scale"),
                 float(cfg["layer_norm_epsilon"]), g)
    return matmul(gated, w(p + "mamba.w_out"))


def _experts(w, p: str, u: Tensor, cfg: dict, matmul, choice=None):
    """u (T, D), normed -> (routed experts plus the shared expert (T, D),
    the choices (T, k), their route gap): the reference's own top k, or
    ``choice`` given."""
    k = int(cfg["num_experts_per_tok"])
    scores = torch.sigmoid(u @ w(p + "moe.router"))               # (T,E)
    biased = scores + w(p + "moe.router_bias")
    top = torch.topk(biased, k, -1)
    if choice is None:
        choice, gap = top.indices, 0.0
    else:
        choice = choice.to(u.device).long()
        repeats = (choice.sort(-1).values.diff(dim=-1) == 0).any()
        gap = float("inf") if repeats else float(torch.clamp(
            top.values[:, -1] - biased.gather(1, choice).amin(-1),
            min=0.0).max())
    weight = scores.gather(1, choice)
    if cfg["norm_topk_prob"]:
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
    weight = weight * float(cfg["routed_scaling_factor"])
    up, down = w(p + "moe.w_up"), w(p + "moe.w_down")
    each = torch.zeros(u.shape[0], k, u.shape[1], device=u.device)
    for e in range(up.shape[0]):
        tok, slot = torch.nonzero(choice == e, as_tuple=True)
        if tok.numel():
            out = matmul(torch.relu(matmul(u[tok], up[e])) ** 2, down[e])
            each[tok, slot] = weight[tok, slot, None] * out
    shared = matmul(torch.relu(matmul(u, w(p + "moe.shared_up"))) ** 2,
                    w(p + "moe.shared_down"))
    return each.sum(1) + shared, choice, gap


def _attention(w, p: str, u: Tensor, cfg: dict, matmul) -> Tensor:
    """u (S, D), normed -> causal GQA's output (S, D), no rotary
    embedding."""
    h, kh = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    hd = int(cfg["head_dim"])
    s = u.shape[0]
    q = matmul(u, w(p + "attn.wq")).reshape(s, h, hd)
    kv = h // kh
    k, v = (matmul(u, w(p + name)).reshape(s, kh, hd).repeat_interleave(kv, 1)
            for name in ("attn.wk", "attn.wv"))
    causal = torch.ones(s, s, dtype=torch.bool, device=u.device).tril()
    o = torch.empty_like(q)
    for h0 in range(0, h, HEAD_BLOCK):
        hs = slice(h0, min(h0 + HEAD_BLOCK, h))
        sc = torch.einsum("thd,shd->hts", q[:, hs], k[:, hs]) * hd ** -0.5
        sc = torch.softmax(torch.where(causal, sc, -torch.inf), -1)
        o[:, hs] = torch.einsum("hts,shd->thd", sc, v[:, hs])
    return matmul(o.reshape(s, h * hd), w(p + "attn.wo"))


def forward(weights: Callable[[str], Tensor], tokens: Tensor, cfg: dict,
            matmul: Callable[[Tensor, Tensor], Tensor] = torch.matmul,
            routes: Optional[Sequence[Tensor]] = None):
    """(pooled features (B, D), risk (B,), the choices of each expert
    layer, the route gap) of ``tokens`` (B, S), one layer at a time: each
    layer's weights are read once, for every sequence. ``routes``: the
    choices to take, one (B S, k) tensor an expert layer."""
    cache: Dict[str, Tensor] = {}

    def w(name: str) -> Tensor:
        if name not in cache:
            cache[name] = weights(name).float()
        return cache[name]

    eps = float(cfg["layer_norm_epsilon"])
    x = w("embed")[tokens.long()]
    cache.clear()
    chosen, route_gap = [], 0.0
    for i, kind in enumerate(cfg["hybrid_override_pattern"]):
        p = f"layers.{i}."
        u = _rms(x, w(p + "ln.scale"), eps)
        if kind == "E":
            given = None if routes is None else routes[len(chosen)]
            y, choice, gap = _experts(w, p, u.reshape(-1, u.shape[-1]), cfg,
                                      matmul, given)
            y = y.reshape(u.shape)
            chosen.append(choice)
            route_gap = max(route_gap, gap)
        else:
            mixer = _mamba if kind == "M" else _attention
            y = torch.stack([mixer(w, p, row, cfg, matmul) for row in u])
        x = x + y
        cache.clear()
    pooled = _rms(x, w("final_norm.scale"), eps).mean(1)
    risk = pooled @ w("cox_head.w")[:, 0] + w("cox_head.b")
    return pooled, risk, chosen, route_gap


def fp8_matmul(a: Tensor, b: Tensor) -> Tensor:
    """a @ b with both operands rounded to float8 e4m3, each scaled by its
    largest magnitude, and the product taken in float32: the control's
    projections."""
    def q(t):
        scale = torch.clamp(t.abs().max(), min=1e-12) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).float() * scale
    return q(a) @ q(b)


def features(weights: Callable[[str], Tensor], tokens: Tensor, cfg: dict,
             matmul=torch.matmul, routes=None):
    """``forward`` with TF32 off."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return forward(weights, tokens, cfg, matmul, routes)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
