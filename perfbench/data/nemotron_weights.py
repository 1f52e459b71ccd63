"""Seeded weights of a Nemotron-H featurizer with a Cox head, each tensor
drawn from (seed, its name) alone: a generator of its own, seeded by the
run's seed and the name's CRC-32, one draw in float32 on the device,
scaled, shifted and rounded to the type it is served in (the matrices,
norms and conv in the configuration's dtype; the router, its correction
bias, the SSM's decay, step bias and skip, and the head in float32).

The program's parameters are filled in place (``fill``), so that the 63
GB of the whole model are made once on the card; the reference draws any
tensor again by its name (``draw``), layer by layer. Norm scales, biases,
the correction bias and the SSM's per-head terms are drawn around their
usual constants, so that a path that drops one of them shows in the
check. Names are the program's parameter names."""
from __future__ import annotations

import zlib
from typing import Dict, Tuple

import torch

from perfbench import harness

# name -> (shape, scale, offset, float32?)
Spec = Dict[str, Tuple[tuple, float, object, bool]]
# scale of the router's correction bias: small beside the scores' spread,
# so that it moves the choice of near ties but not the weights
BIAS_SCALE = 0.05


def spec(cfg: dict) -> Spec:
    d = int(cfg["hidden_size"])
    rows = -(-int(cfg["vocab_size"]) // 256) * 256
    h, hd = int(cfg["mamba_num_heads"]), int(cfg["mamba_head_dim"])
    di, gn = h * hd, int(cfg["n_groups"]) * int(cfg["ssm_state_size"])
    e = int(cfg["n_routed_experts"])
    ff = int(cfg["moe_intermediate_size"])
    fs = int(cfg["moe_shared_expert_intermediate_size"])
    q = int(cfg["num_attention_heads"]) * int(cfg["head_dim"])
    kv = int(cfg["num_key_value_heads"]) * int(cfg["head_dim"])
    a_log = torch.log(torch.linspace(1.0, 16.0, h))
    out: Spec = {
        "embed": ((rows, d), 0.02, 0.0, False),
        "final_norm.scale": ((d,), 0.1, 1.0, False),
        "lm_head": ((d, rows), d ** -0.5, 0.0, False),
    }
    for i, kind in enumerate(cfg["hybrid_override_pattern"]):
        p = f"layers.{i}."
        out[p + "ln.scale"] = ((d,), 0.1, 1.0, False)
        if kind == "M":
            out.update({
                p + "mamba.w_in": ((d, 2 * di + 2 * gn + h), d ** -0.5, 0.0,
                                   False),
                p + "mamba.conv_w": ((int(cfg["conv_kernel"]), di + 2 * gn),
                                     0.2, 0.0, False),
                p + "mamba.conv_b": ((di + 2 * gn,), 0.1, 0.0, False),
                p + "mamba.a_log": ((h,), 0.1, a_log, True),
                p + "mamba.dt_bias": ((h,), 0.5, -2.0, True),
                p + "mamba.d_skip": ((h,), 0.1, 1.0, True),
                p + "mamba.norm_scale": ((di,), 0.1, 1.0, False),
                p + "mamba.w_out": ((di, d), di ** -0.5, 0.0, False),
            })
        elif kind == "E":
            out.update({
                p + "moe.router": ((d, e), d ** -0.5, 0.0, True),
                p + "moe.router_bias": ((e,), BIAS_SCALE, 0.0, True),
                p + "moe.w_up": ((e, d, ff), d ** -0.5, 0.0, False),
                p + "moe.w_down": ((e, ff, d), ff ** -0.5, 0.0, False),
                p + "moe.shared_up": ((d, fs), d ** -0.5, 0.0, False),
                p + "moe.shared_down": ((fs, d), fs ** -0.5, 0.0, False),
            })
        else:
            out.update({
                p + "attn.wq": ((d, q), d ** -0.5, 0.0, False),
                p + "attn.wk": ((d, kv), d ** -0.5, 0.0, False),
                p + "attn.wv": ((d, kv), d ** -0.5, 0.0, False),
                p + "attn.wo": ((q, d), q ** -0.5, 0.0, False),
            })
    out["cox_head.w"] = ((d, 1), 0.05, 0.0, True)
    out["cox_head.b"] = ((), 0.1, 0.0, True)
    return out


def _draw(sp: Spec, dtype, seed: int, name: str, device) -> torch.Tensor:
    shape, scale, offset, f32 = sp[name]
    gen = torch.Generator(device).manual_seed(
        harness.torch_seed(seed, zlib.crc32(name.encode())))
    leaf = torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(scale)
    if isinstance(offset, torch.Tensor):
        leaf.add_(offset.to(device))
    elif offset:
        leaf.add_(offset)
    return leaf if f32 else leaf.to(dtype)


def draw(cfg: dict, seed: int, name: str, device="cuda") -> torch.Tensor:
    """The tensor ``name`` of ``spec(cfg)``, drawn from (``seed``, name)."""
    return _draw(spec(cfg), getattr(torch, cfg["dtype"]), seed, name, device)


@torch.no_grad()
def fill(model, cfg: dict, seed: int) -> Dict[str, torch.Tensor]:
    """Draw every parameter of the program's ``model`` in place, and its
    Cox head (which it gets, as ``cox_head``); returns the head."""
    sp = spec(cfg)
    dtype = getattr(torch, cfg["dtype"])
    dev = model.device
    head = {k: _draw(sp, dtype, seed, k, dev)
            for k in ("cox_head.w", "cox_head.b")}
    model.cox_head = torch.nn.ParameterDict({
        k.split(".")[1]: torch.nn.Parameter(v.clone())
        for k, v in head.items()})
    params = dict(model.named_parameters())
    if set(params) != set(sp):
        raise ValueError(f"the program's parameters and the benchmark's "
                         f"differ: {sorted(set(params) ^ set(sp))[:8]}")
    for name, p in params.items():
        if name.startswith("cox_head."):
            continue
        if tuple(p.shape) != sp[name][0] or p.dtype != (
                torch.float32 if sp[name][3] else dtype):
            raise ValueError(f"{name}: the program holds {tuple(p.shape)} "
                             f"{p.dtype}, the benchmark draws {sp[name][0]}")
        p.copy_(_draw(sp, dtype, seed, name, dev))
    return head
