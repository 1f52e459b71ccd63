"""Plain PyTorch reference of the Kimi Linear featurizer (``model_type``
``kimi_linear``, Kimi-Linear-48B-A3B): token embedding, then for each of
``num_hidden_layers`` layers a mixer and an FFN, each a pre-norm residual
sublayer,

    x <- x + mixer(RMSNorm(x)),   mixer: KDA (``kda_layers``) or MLA
                                  (``full_attn_layers``), 1-based
    x <- x + ffn(RMSNorm(x)),     ffn: a dense SwiGLU for the first
                                  ``first_k_dense_replace`` layers, then
                                  sparse experts

then the final RMSNorm, the mean over every position and a Cox head.

- KDA, H heads of d (``linear_attn_config``): q, k, v projections, each a
  depthwise causal conv of ``short_conv_kernel_size`` taps without bias and
  SiLU; q and k L2-normalised per head (x / sqrt(sum x^2 + 1e-6)); the
  log decay g = -exp(A_log[h]) softplus(x F_a F_b + dt_bias), one per key
  channel; beta = sigmoid(x W_b); the gated delta rule token by token,

      S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} + beta_t k_t v_t^T,
      o_t = S_t^T q_t d^-1/2;

  then RMSNorm over each head's d channels, times sigmoid(x G_a G_b), and
  the output projection.
- MLA (``q_lora_rank`` null): q = x W_q, (H, qk_nope + qk_rope); [c, k_pe]
  = x W_kv_a; c RMS-normed; [k_nope, v] = c W_kv_b, (H, qk_nope +
  v_head_dim); k = [k_nope, k_pe for every head]; causal softmax of q.k
  at scale (qk_nope + qk_rope)^-1/2, computed in blocks of heads; the
  output projection.
- Experts: sigmoid scores of the router over all of the published
  ``num_experts_published``; the top ``num_experts_per_token`` of score +
  correction bias choose; the chosen plain scores, over their sum
  (``moe_renormalize``), times ``routed_scaling_factor``, weigh each
  chosen expert's silu(x W_gate) (x W_up) W_down; plus the shared
  expert's on every token. Only the held experts (``experts_held``, ids
  [first, stop)) are computed, one expert at a time: the others' part of
  the result is another card's, and is left out here as in the program.

Departures from the published model: ``mla_use_nope`` is read as no
rotary embedding on q_pe and k_pe (64 channels each, unrotated); the
top-level ``head_dim`` (72) is read by no layer; grouped top-k with one
group is the plain top-k; the LM head is not computed (the featurizer
reads the final hidden state); the Cox head on the pooled features is the
benchmark's; only the held share of the experts is computed (above).

It computes in float32 with TF32 off, from weights given by the
program's parameter names (``weights(name)``, upcast to float32 here),
one sublayer at a time over every sequence, so that a caller can draw
each sublayer's weights after the last one's are dropped. ``matmul`` may
be replaced for the projections, the experts and the shared expert (the
control computes them in float8); the router stays float32.

A top-k choice is discrete: where another computation's rounding moves a
token's k-th and (k+1)-th biased scores past each other, its output
differs by a whole expert. So the reference can take the choices
(``routes``, each expert layer's (T, k) experts among all of them, T = B
S in batch order) from the computation it checks and recompute the rest
at them; it then reports ``route_gap``, the largest over tokens and
layers of its own k-th biased score less the lowest biased score among
the given choices (0 where they are its own top k, infinite where one
token repeats an expert). Imports nothing of the program."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
# heads of attention computed at once: bounds the (heads, S, S) float32
# scores
HEAD_BLOCK = 8
L2_EPS = 1e-6


def pattern(cfg: dict) -> str:
    """Two characters a layer: its mixer (K for KDA, L for MLA) and its FFN
    (- dense, E experts)."""
    la = cfg["linear_attn_config"]
    kda, full = set(la["kda_layers"]), set(la["full_attn_layers"])
    dense = int(cfg["first_k_dense_replace"])
    out = ""
    for i in range(1, int(cfg["num_hidden_layers"]) + 1):
        if (i in kda) == (i in full):
            raise ValueError(f"layer {i}: in both or neither of kda_layers "
                             f"and full_attn_layers")
        out += ("K" if i in kda else "L") + ("-" if i <= dense else "E")
    return out


def _rms(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * scale


def _swiglu(u: Tensor, gate: Tensor, up: Tensor, down: Tensor,
            matmul) -> Tensor:
    return matmul(F.silu(matmul(u, gate)) * matmul(u, up), down)


def _l2(x: Tensor) -> Tensor:
    return x * torch.rsqrt(torch.sum(x * x, -1, keepdim=True) + L2_EPS)


def _delta_rule(q: Tensor, k: Tensor, v: Tensor, g: Tensor,
                beta: Tensor) -> Tensor:
    """The gated delta rule token by token: q, k, g (B, S, H, d), v (B, S,
    H, dv), beta (B, S, H) -> o (B, S, H, dv)."""
    b, s, h, d = k.shape
    state = torch.zeros(b, h, d, v.shape[-1], device=k.device)
    decay = torch.exp(g)
    q = q * d ** -0.5
    o = torch.empty(b, s, h, v.shape[-1], device=k.device)
    for t in range(s):
        state.mul_(decay[:, t, :, :, None])
        kt = k[:, t, :, None, :]                                 # (B,H,1,d)
        err = v[:, t, :, None, :] - kt @ state                   # (B,H,1,dv)
        state.add_(kt.transpose(-1, -2) @ (beta[:, t, :, None, None] * err))
        o[:, t] = (q[:, t, :, None, :] @ state)[:, :, 0]
    return o


def _kda(w, p: str, u: Tensor, cfg: dict, matmul) -> Tensor:
    """u (B, S, D), normed -> the KDA mixer's output (B, S, D)."""
    la = cfg["linear_attn_config"]
    h, d = int(la["num_heads"]), int(la["head_dim"])
    width = int(la["short_conv_kernel_size"])
    b, s, _ = u.shape
    hd = h * d
    proj = matmul(u, w(p + "kda.w_in"))
    cw = w(p + "kda.conv_w")
    xp = F.pad(proj[..., :3 * hd], (0, 0, width - 1, 0))
    qkv = F.silu(sum(xp[:, j:j + s] * cw[j] for j in range(width)))
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(hd, -1))
    f_a, g_a, beta = proj[..., 3 * hd:].split([d, d, h], -1)
    g = -torch.exp(w(p + "kda.a_log"))[:, None] * F.softplus(
        matmul(f_a, w(p + "kda.w_f")) + w(p + "kda.dt_bias")).reshape(
            b, s, h, d)
    o = _delta_rule(_l2(q), _l2(k), v, g, torch.sigmoid(beta))
    o = _rms(o, w(p + "kda.norm_scale"), float(cfg["rms_norm_eps"])) \
        * torch.sigmoid(matmul(g_a, w(p + "kda.w_g"))).reshape(b, s, h, d)
    return matmul(o.reshape(b, s, hd), w(p + "kda.w_out"))


def _mla(w, p: str, u: Tensor, cfg: dict, matmul) -> Tensor:
    """u (S, D), normed -> causal latent attention's output (S, D), no
    rotary embedding."""
    h = int(cfg["num_attention_heads"])
    dn, dr = int(cfg["qk_nope_head_dim"]), int(cfg["qk_rope_head_dim"])
    dv, r = int(cfg["v_head_dim"]), int(cfg["kv_lora_rank"])
    s = u.shape[0]
    q = matmul(u, w(p + "mla.wq")).reshape(s, h, dn + dr)
    ckv = matmul(u, w(p + "mla.wkv_a"))
    c = _rms(ckv[:, :r], w(p + "mla.kv_norm"), float(cfg["rms_norm_eps"]))
    kv = matmul(c, w(p + "mla.wkv_b")).reshape(s, h, dn + dv)
    k = torch.cat([kv[..., :dn], ckv[:, None, r:].expand(s, h, dr)], -1)
    v = kv[..., dn:]
    causal = torch.ones(s, s, dtype=torch.bool, device=u.device).tril()
    o = torch.empty(s, h, dv, device=u.device)
    for h0 in range(0, h, HEAD_BLOCK):
        hs = slice(h0, min(h0 + HEAD_BLOCK, h))
        sc = torch.einsum("thd,shd->hts", q[:, hs], k[:, hs]) \
            * (dn + dr) ** -0.5
        sc = torch.softmax(torch.where(causal, sc, -torch.inf), -1)
        o[:, hs] = torch.einsum("hts,shd->thd", sc, v[:, hs])
    return matmul(o.reshape(s, h * dv), w(p + "mla.wo"))


def _experts(w, p: str, u: Tensor, cfg: dict, matmul, choice=None):
    """u (T, D), normed -> (the held experts' part plus the shared expert
    (T, D), the choices (T, k), their route gap): the reference's own top
    k, or ``choice`` given."""
    k = int(cfg["num_experts_per_token"])
    first, stop = (int(i) for i in cfg["experts_held"])
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
    if cfg["moe_renormalize"]:
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
    weight = weight * float(cfg["routed_scaling_factor"])
    gate, up, down = (w(p + f"moe.{n}") for n in ("w_gate", "w_up",
                                                  "w_down"))
    each = torch.zeros(u.shape[0], k, u.shape[1], device=u.device)
    for e in range(first, stop):
        tok, slot = torch.nonzero(choice == e, as_tuple=True)
        if tok.numel():
            out = _swiglu(u[tok], gate[e - first], up[e - first],
                          down[e - first], matmul)
            each[tok, slot] = weight[tok, slot, None] * out
    shared = _swiglu(u, w(p + "moe.shared_gate"), w(p + "moe.shared_up"),
                     w(p + "moe.shared_down"), matmul)
    return each.sum(1) + shared, choice, gap


def forward(weights: Callable[[str], Tensor], tokens: Tensor, cfg: dict,
            matmul: Callable[[Tensor, Tensor], Tensor] = torch.matmul,
            routes: Optional[Sequence[Tensor]] = None):
    """(pooled features (B, D), risk (B,), the choices of each expert
    layer, the route gap) of ``tokens`` (B, S), one sublayer at a time:
    each sublayer's weights are read once, for every sequence. ``routes``:
    the choices to take, one (B S, k) tensor an expert layer."""
    cache: Dict[str, Tensor] = {}

    def w(name: str) -> Tensor:
        if name not in cache:
            cache[name] = weights(name).float()
        return cache[name]

    eps = float(cfg["rms_norm_eps"])
    x = w("embed")[tokens.long()]
    cache.clear()
    chosen, route_gap = [], 0.0
    for i, kind in enumerate(pattern(cfg)):
        p = f"layers.{i}."
        u = _rms(x, w(p + "ln.scale"), eps)
        if kind == "E":
            given = None if routes is None else routes[len(chosen)]
            y, choice, gap = _experts(w, p, u.reshape(-1, u.shape[-1]), cfg,
                                      matmul, given)
            y = y.reshape(u.shape)
            chosen.append(choice)
            route_gap = max(route_gap, gap)
        elif kind == "-":
            y = _swiglu(u, w(p + "mlp.w_gate"), w(p + "mlp.w_up"),
                        w(p + "mlp.w_down"), matmul)
        elif kind == "K":
            y = _kda(w, p, u, cfg, matmul)
        else:
            y = torch.stack([_mla(w, p, row, cfg, matmul) for row in u])
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
