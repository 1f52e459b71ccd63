"""Seeded weights of a Mamba2 language model with a Cox head, made on the
device: one draw of the card's generator for all of them, cut into
leaves, scaled and rounded to the type each is served in (the matrices,
norms and conv in the configuration's dtype; the SSM's decay, step bias
and skip in float32). Norm scales, biases and the SSM's per-head terms
are drawn too, around their usual constants, so that a path that drops
one of them shows in the check.

Leaves are named as the program's model names its parameters; the
reference reads the same tensors by these names."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

# name -> (shape, scale, offset, float32?)
Spec = Dict[str, Tuple[tuple, float, object, bool]]


def spec(cfg: dict) -> Spec:
    d = int(cfg["d_model"])
    di = int(cfg["expand"]) * d
    n = int(cfg["d_state"])
    h = di // int(cfg["headdim"])
    conv = di + 2 * int(cfg["ngroups"]) * n
    rows = -(-int(cfg["vocab_size"]) // 256) * 256
    out: Spec = {
        "embed": ((rows, d), 0.02, 0.0, False),
        "lm_head": ((d, rows), d ** -0.5, 0.0, False),
        "final_norm.scale": ((d,), 0.1, 1.0, False),
    }
    a_log = torch.log(torch.linspace(1.0, 16.0, h))
    for i in range(int(cfg["n_layer"])):
        p = f"layers.{i}."
        out.update({
            p + "ln.scale": ((d,), 0.1, 1.0, False),
            p + "mamba.w_in": ((d, 2 * di + 2 * n + h), d ** -0.5, 0.0,
                               False),
            p + "mamba.conv_w": ((int(cfg["d_conv"]), conv), 0.2, 0.0,
                                 False),
            p + "mamba.conv_b": ((conv,), 0.1, 0.0, False),
            p + "mamba.a_log": ((h,), 0.1, a_log, True),
            p + "mamba.dt_bias": ((h,), 0.5, -2.0, True),
            p + "mamba.d_skip": ((h,), 0.1, 1.0, True),
            p + "mamba.norm_scale": ((di,), 0.1, 1.0, False),
            p + "mamba.w_out": ((di, d), di ** -0.5, 0.0, False),
        })
    out["cox_head.w"] = ((d, 1), 0.05, 0.0, True)
    out["cox_head.b"] = ((), 0.1, 0.0, True)
    return out


def make(cfg: dict, seed: int, device="cuda") -> Dict[str, torch.Tensor]:
    """Every leaf of ``spec(cfg)``, drawn from ``seed``."""
    sp = spec(cfg)
    dtype = getattr(torch, cfg["dtype"])
    total = sum(math.prod(s) for s, _, _, _ in sp.values())
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, dtype=torch.float32,
                       device=device)
    out, off = {}, 0
    for name, (shape, scale, offset, f32) in sp.items():
        size = math.prod(shape)
        leaf = flat[off:off + size].view(shape) * scale
        if isinstance(offset, torch.Tensor):
            leaf = leaf + offset.to(device)
        elif offset:
            leaf = leaf + offset
        out[name] = leaf.to(torch.float32 if f32 else dtype)
        off += size
    return out
