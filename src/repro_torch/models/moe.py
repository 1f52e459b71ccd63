"""Top-k (Mixtral: top-2) mixture-of-experts FFN with capacity-based
scatter/gather dispatch.

The PyTorch port's counterpart of the JAX package's ``models/moe.py``, with
the reference's semantics: each (token, choice) pair takes the next free
slot of its expert, first come first served by token index (one cumsum
over (T*k, E)); an expert holds ``max(int(capacity_factor * T * k / E),
8)`` slots; overflow goes to a trash slot whose gather reads zeros. The
expert FFNs run as E-batched GEMMs over the (E, C, D) buffer, their
products summed in float32 and silu taken before any rounding, as the
reference's ``preferred_element_type=float32``.

The buffer has one row more than E * C, the trash slot, which is sliced
off: an index write cannot drop an out-of-bounds row as the reference's
``mode="drop"`` scatter does. ``moe_ffn`` is ``route`` then ``dispatch``,
so that a check can hold the experts' numerics at given routes.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from .layers import normal

Tensor = torch.Tensor


def init_moe(d_model: int, d_ff: int, n_experts: int, dtype=torch.bfloat16,
             device="cuda") -> nn.ParameterDict:
    s = d_model ** -0.5
    return nn.ParameterDict({
        "router": normal((d_model, n_experts), s, torch.float32, device),
        "w_gate": normal((n_experts, d_model, d_ff), s, dtype, device),
        "w_up": normal((n_experts, d_model, d_ff), s, dtype, device),
        "w_down": normal((n_experts, d_ff, d_model), d_ff ** -0.5, dtype,
                         device),
    })


def _bmm_f32(a: Tensor, b: Tensor) -> Tensor:
    """a @ b per expert with float32 output: products of bfloat16 operands
    summed in float32. On the card one GEMM writes float32 from bfloat16
    operands; the CPU has no such GEMM, so there the operands are upcast
    (exact: a bfloat16 value is a float32 value)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def capacity(t: int, k: int, e: int, capacity_factor: float) -> int:
    """Slots an expert holds for ``t`` tokens of ``k`` choices each."""
    return max(int(capacity_factor * t * k / e), 8)


def route(params: Mapping[str, Tensor], x: Tensor, k: int):
    """The router: (probs (T, E) float32, the top-k weights renormalized
    and rounded to x's dtype (T, k), the top-k experts (T, k)) for the
    T = B * S tokens of x (B, S, D)."""
    xt = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xt.float() @ params["router"], dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    return probs, (topv / topv.sum(dim=-1, keepdim=True)).to(x.dtype), topi


def dispatch(params: Mapping[str, Tensor], x: Tensor, probs: Tensor,
             topv: Tensor, topi: Tensor, capacity_factor: float = 1.25):
    """The experts on x (B, S, D) routed by ``route``'s output: (out (B,
    S, D), aux load-balancing loss)."""
    b, s, d = x.shape
    e = params["w_gate"].shape[0]
    t, k = topi.shape
    xt = x.reshape(t, d)
    cap = capacity(t, k, e, capacity_factor)
    # position of each (token, choice) within its expert, FCFS by token
    flat_e = topi.reshape(t * k)
    onehot = F.one_hot(flat_e, e)                                   # (T*k, E)
    pos = torch.cumsum(onehot, dim=0).gather(1, flat_e[:, None])[:, 0] - 1
    slot = torch.where(pos < cap, flat_e * cap + pos, e * cap)

    buf = x.new_zeros(e * cap + 1, d)
    buf[slot] = xt.repeat_interleave(k, dim=0)
    xin = buf[:e * cap].reshape(e, cap, d)
    hmid = (F.silu(_bmm_f32(xin, params["w_gate"]))
            * _bmm_f32(xin, params["w_up"])).to(x.dtype)
    xout = _bmm_f32(hmid, params["w_down"]).to(x.dtype)

    # gather back (the trash slot reads zeros), combine with the weights
    back = torch.cat([xout.reshape(e * cap, d), xout.new_zeros(1, d)])
    out = (back[slot].reshape(t, k, d) * topv[..., None]).sum(dim=1)

    # Switch-style load-balance aux: E * sum_e f_e * p_e
    frac = onehot.reshape(t, k, e).sum(dim=1).float().mean(dim=0)
    aux = e * torch.sum(frac * probs.mean(dim=0))
    return out.reshape(b, s, d), aux


def moe_ffn(params: Mapping[str, Tensor], x: Tensor,
            n_experts_per_tok: int = 2, capacity_factor: float = 1.25):
    """x: (B, S, D) -> (out (B, S, D), aux load-balancing loss)."""
    return dispatch(params, x, *route(params, x, n_experts_per_tok),
                    capacity_factor)
