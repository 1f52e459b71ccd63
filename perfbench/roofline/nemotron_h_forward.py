"""Floating-point operations of a Nemotron-H forward pass a token at
sequence length S, without the LM head (2 per multiply-add):

    Mamba2 layer (M)     2 D (2 Di + 2 G N + H)   input projection
                         2 W (Di + 2 G N)         causal conv
                         5 Di N                   SSD, recurrent
                         8 Di                     skip, gating, gated norm
                         2 Di D                   output projection
    expert layer (E)     2 D E                    router
                         k (4 D F + 2 F)          k relu^2 experts
                         4 D Fs + 2 Fs            the shared expert
    attention layer (*)  2 D (H + 2 KH) hd        q, k, v projections
                         2 H hd (S + 1)           causal q.k and p.v,
                                                  (S + 1) / 2 keys a query
                         2 H hd D                 output projection
    every layer          4 D                      its RMSNorm

with Di = H_m x headdim, G groups of B and C, state N, conv width W; then
the final RMSNorm, 4 D, and the mean pooling, D. The SSD is counted in
its recurrent form as ``mamba2_forward.py`` counts it (3 a state element
for its decay and update, 2 for its read-out), the least work of the scan
whatever chunk an implementation runs; attention counts only the causal
half of its scores."""
from __future__ import annotations


def layer_flops(cfg: dict, seq: int) -> dict:
    """FLOPs a token of one layer of each kind, by its pattern character."""
    d = int(cfg["hidden_size"])
    hm, hdm = int(cfg["mamba_num_heads"]), int(cfg["mamba_head_dim"])
    di = hm * hdm
    gn = int(cfg["n_groups"]) * int(cfg["ssm_state_size"])
    n = int(cfg["ssm_state_size"])
    w = int(cfg["conv_kernel"])
    e = int(cfg["n_routed_experts"])
    k = int(cfg["num_experts_per_tok"])
    ff = int(cfg["moe_intermediate_size"])
    fs = int(cfg["moe_shared_expert_intermediate_size"])
    h, kh = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    hd = int(cfg["head_dim"])
    norm = 4 * d
    return {
        "M": (2 * d * (2 * di + 2 * gn + hm) + 2 * w * (di + 2 * gn)
              + 5 * di * n + 8 * di + 2 * di * d + norm),
        "E": 2 * d * e + k * (4 * d * ff + 2 * ff) + 4 * d * fs + 2 * fs
        + norm,
        "*": (2 * d * (h + 2 * kh) * hd + 2 * h * hd * (seq + 1)
              + 2 * h * hd * d + norm),
    }


def flops_per_token(cfg: dict, seq: int) -> float:
    per = layer_flops(cfg, seq)
    d = int(cfg["hidden_size"])
    return sum(per[c] for c in cfg["hybrid_override_pattern"]) + 4 * d + d
