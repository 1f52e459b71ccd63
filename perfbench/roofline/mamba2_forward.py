"""Floating-point operations of a Mamba2 forward pass a token, without the
LM head (2 per multiply-add):

    input projection   2 D (2 Di + 2 G N + H)
    causal conv        2 W (Di + 2 G N)
    SSD, recurrent     5 Di N   (decay and update of the (hd, N) state of
                                  every head, 3 a state element, and its
                                  read-out by C, 2 an element)
    skip and gating    4 Di
    gated RMSNorm      4 Di
    output projection  2 Di D
    RMSNorm            4 D

per layer, Di = expand D, H = Di / headdim, G groups of B and C, a conv of
width W; then the final RMSNorm, 4 D, and the mean pooling, D. The SSD is
counted in its recurrent form, the least work of the scan whatever chunk
an implementation runs: a chunked implementation does more, and that is
its cost."""
from __future__ import annotations


def flops_per_token(cfg: dict) -> float:
    d = int(cfg["d_model"])
    di = int(cfg["expand"]) * d
    n = int(cfg["d_state"])
    g = int(cfg["ngroups"])
    h = di // int(cfg["headdim"])
    w = int(cfg["d_conv"])
    layer = (2 * d * (2 * di + 2 * g * n + h) + 2 * w * (di + 2 * g * n)
             + 5 * di * n + 4 * di + 4 * di + 2 * di * d + 4 * d)
    return int(cfg["n_layer"]) * layer + 4 * d + d
