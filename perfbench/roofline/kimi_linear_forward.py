"""Floating-point operations of a Kimi Linear forward pass a token at
sequence length S on a card that holds ``experts_held`` of the router's
experts, without the LM head (2 per multiply-add):

    KDA layer (K)        2 D (3 H d + 2 d + H)      input projection
                         2 W 3 H d                  causal conv
                         2 d H d x 2                decay and gate (F_b, G_b)
                         7 H d d                    delta rule, recurrent
                         2 H d D                    output projection
    MLA layer (L)        2 D Hq (dn + dr)           query projection
                         2 D (r + dr)               compressed KV
                         2 r Hq (dn + dv)           KV decompression
                         Hq (dn + dr + dv) (S + 1)  causal q.k and p.v,
                                                    (S + 1) / 2 keys a query
                         2 Hq dv D                  output projection
    dense layer (-)      6 D Fd                     SwiGLU
    expert layer (E)     2 D E                      router
                         k n / E (6 D F)            the held share of k
                                                    SwiGLU experts
                         6 D Fs                     the shared expert
    every sublayer       4 D                        its RMSNorm

with H heads of d in KDA, conv width W, Hq heads in MLA, n of E experts
held; then the final RMSNorm, 4 D, and the mean pooling, D. The delta
rule is counted in its recurrent form, the least work whatever chunk an
implementation runs: the decay (1 a state element), k^T S (2), the
rank-one update (2) and the read-out q^T S (2). Attention counts only the
causal half of its scores. A token's expected pairs on this card are k n
/ E; its elementwise terms (activations, norms of q and k) are left out."""
from __future__ import annotations


def layer_flops(cfg: dict, seq: int) -> dict:
    """FLOPs a token of one sublayer of each kind, by its pattern
    character."""
    d = int(cfg["hidden_size"])
    la = cfg["linear_attn_config"]
    h, hk = int(la["num_heads"]), int(la["head_dim"])
    w = int(la["short_conv_kernel_size"])
    hq = int(cfg["num_attention_heads"])
    dn, dr = int(cfg["qk_nope_head_dim"]), int(cfg["qk_rope_head_dim"])
    dv, r = int(cfg["v_head_dim"]), int(cfg["kv_lora_rank"])
    e = int(cfg["num_experts_published"])
    first, stop = (int(i) for i in cfg["experts_held"])
    k = int(cfg["num_experts_per_token"])
    ff = int(cfg["moe_intermediate_size"])
    fs = ff * int(cfg["num_shared_experts"])
    fd = int(cfg["intermediate_size"])
    norm = 4 * d
    return {
        "K": (2 * d * (3 * h * hk + 2 * hk + h) + 2 * w * 3 * h * hk
              + 2 * 2 * hk * h * hk + 7 * h * hk * hk + 2 * h * hk * d
              + norm),
        "L": (2 * d * hq * (dn + dr) + 2 * d * (r + dr)
              + 2 * r * hq * (dn + dv) + hq * (dn + dr + dv) * (seq + 1)
              + 2 * hq * dv * d + norm),
        "-": 6 * d * fd + norm,
        "E": 2 * d * e + k * (stop - first) / e * 6 * d * ff + 6 * d * fs
        + norm,
    }


def flops_per_token(cfg: dict, seq: int) -> float:
    from perfbench.reference import kimi_linear

    per = layer_flops(cfg, seq)
    d = int(cfg["hidden_size"])
    return sum(per[c] for c in kimi_linear.pattern(cfg)) + 4 * d + d
