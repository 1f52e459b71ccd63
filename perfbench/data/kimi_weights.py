"""Seeded weights of a Kimi Linear featurizer with a Cox head, each tensor
drawn from (seed, its name) alone: a generator of its own, seeded by the
run's seed and the name's CRC-32, one draw in float32 on the device,
shaped and rounded to the type it is served in (the matrices, norms and
conv in the configuration's dtype; the router, its correction bias, the
KDA gate's decay and bias, and the head in float32).

The program's parameters are filled in place (``fill``), so that the 51
GB of this card's share are made once on the card; the reference draws
any tensor again by its name (``draw``), sublayer by sublayer. Norm
scales are drawn around 1, so that a path that drops one shows in the
check. ``A_log`` is log U(1, 16) and ``dt_bias`` Mamba2's dt bias, as the
configuration's ``assumed`` says. Names are the program's parameter
names; the experts' first axis holds the card's share."""
from __future__ import annotations

import math
import zlib
from typing import Dict, Tuple

import torch

from perfbench import harness
from perfbench.reference import kimi_linear

# name -> (shape, kind, scale, float32?); kind "normal" draws scale x
# N(0, 1), "norm" 1 + scale x N(0, 1), "a_log" and "dt_bias" as above
Spec = Dict[str, Tuple[tuple, str, float, bool]]
# scale of the router's correction bias: small beside the scores' spread,
# so that it moves the choice of near ties but not the weights
BIAS_SCALE = 0.05


def spec(cfg: dict) -> Spec:
    d = int(cfg["hidden_size"])
    rows = -(-int(cfg["vocab_size"]) // 256) * 256
    la = cfg["linear_attn_config"]
    h, hdk = int(la["num_heads"]), int(la["head_dim"])
    hd = h * hdk
    width = int(la["short_conv_kernel_size"])
    n = int(cfg["num_attention_heads"])
    dn, dr = int(cfg["qk_nope_head_dim"]), int(cfg["qk_rope_head_dim"])
    dv, r = int(cfg["v_head_dim"]), int(cfg["kv_lora_rank"])
    e = int(cfg["num_experts_published"])
    first, stop = (int(i) for i in cfg["experts_held"])
    held = stop - first
    ff = int(cfg["moe_intermediate_size"])
    fs = ff * int(cfg["num_shared_experts"])
    dense = int(cfg["intermediate_size"])
    mat = lambda shape, fan: (shape, "normal", fan ** -0.5, False)  # noqa
    out: Spec = {
        "embed": ((rows, d), "normal", 0.02, False),
        "final_norm.scale": ((d,), "norm", 0.1, False),
        "lm_head": mat((d, rows), d),
    }
    for i, kind in enumerate(kimi_linear.pattern(cfg)):
        p = f"layers.{i}."
        out[p + "ln.scale"] = ((d,), "norm", 0.1, False)
        if kind == "K":
            out.update({
                p + "kda.w_in": mat((d, 3 * hd + 2 * hdk + h), d),
                p + "kda.conv_w": ((width, 3 * hd), "normal", 0.2, False),
                p + "kda.w_f": mat((hdk, hd), hdk),
                p + "kda.w_g": mat((hdk, hd), hdk),
                p + "kda.a_log": ((h,), "a_log", 0.0, True),
                p + "kda.dt_bias": ((hd,), "dt_bias", 0.0, True),
                p + "kda.norm_scale": ((hdk,), "norm", 0.1, False),
                p + "kda.w_out": mat((hd, d), hd),
            })
        elif kind == "L":
            out.update({
                p + "mla.wq": mat((d, n * (dn + dr)), d),
                p + "mla.wkv_a": mat((d, r + dr), d),
                p + "mla.kv_norm": ((r,), "norm", 0.1, False),
                p + "mla.wkv_b": mat((r, n * (dn + dv)), r),
                p + "mla.wo": mat((n * dv, d), n * dv),
            })
        elif kind == "-":
            out.update({
                p + "mlp.w_gate": mat((d, dense), d),
                p + "mlp.w_up": mat((d, dense), d),
                p + "mlp.w_down": mat((dense, d), dense),
            })
        else:
            out.update({
                p + "moe.router": ((d, e), "normal", d ** -0.5, True),
                p + "moe.router_bias": ((e,), "normal", BIAS_SCALE, True),
                p + "moe.w_up": mat((held, d, ff), d),
                p + "moe.w_down": mat((held, ff, d), ff),
                p + "moe.shared_up": mat((d, fs), d),
                p + "moe.shared_down": mat((fs, d), fs),
                p + "moe.w_gate": mat((held, d, ff), d),
                p + "moe.shared_gate": mat((d, fs), d),
            })
    out["cox_head.w"] = ((d, 1), "normal", 0.05, True)
    out["cox_head.b"] = ((), "normal", 0.1, True)
    return out


def _draw(sp: Spec, dtype, seed: int, name: str, device) -> torch.Tensor:
    shape, kind, scale, f32 = sp[name]
    gen = torch.Generator(device).manual_seed(
        harness.torch_seed(seed, zlib.crc32(name.encode())))
    if kind in ("a_log", "dt_bias"):
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        if kind == "a_log":
            return torch.log(1.0 + 15.0 * u)
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.clamp(torch.exp(lo + (hi - lo) * u), min=1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    leaf = torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(scale)
    if kind == "norm":
        leaf.add_(1.0)
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
