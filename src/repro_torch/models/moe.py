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
so that a check can hold the experts' numerics at given routes. On
DTensors each step runs on local shards (``_moe_on_mesh``).
"""
from __future__ import annotations

import functools
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate

from . import pspec
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
    e = params["w_gate"].shape[0]
    out = _experts(x, topv, topi, params["w_gate"], params["w_up"],
                   params["w_down"], capacity_factor)
    return out, _aux(probs, topi, e)


def _experts(x: Tensor, topv: Tensor, topi: Tensor, w_gate: Tensor,
             w_up: Tensor, w_down: Tensor, capacity_factor: float) -> Tensor:
    b, s, d = x.shape
    e = w_gate.shape[0]
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
    hmid = (F.silu(_bmm_f32(xin, w_gate)) * _bmm_f32(xin, w_up)).to(x.dtype)
    xout = _bmm_f32(hmid, w_down).to(x.dtype)

    # gather back (the trash slot reads zeros), combine with the weights
    back = torch.cat([xout.reshape(e * cap, d), xout.new_zeros(1, d)])
    out = (back[slot].reshape(t, k, d) * topv[..., None]).sum(dim=1)
    return out.reshape(b, s, d)


def _aux(probs: Tensor, topi: Tensor, e: int) -> Tensor:
    """Switch-style load-balance aux: E * sum_e f_e * p_e."""
    t, k = topi.shape
    onehot = F.one_hot(topi.reshape(t * k), e)
    frac = onehot.reshape(t, k, e).sum(dim=1).float().mean(dim=0)
    return e * torch.sum(frac * probs.mean(dim=0))


def moe_ffn(params: Mapping[str, Tensor], x: Tensor,
            n_experts_per_tok: int = 2, capacity_factor: float = 1.25):
    """x: (B, S, D) -> (out (B, S, D), aux load-balancing loss)."""
    if isinstance(x, DTensor):
        return _moe_on_mesh(params, x, n_experts_per_tok, capacity_factor)
    return dispatch(params, x, *route(params, x, n_experts_per_tok),
                    capacity_factor)


def _moe_on_mesh(params, x: Tensor, k: int, capacity_factor: float):
    """``moe_ffn`` on DTensors, in three steps that each run on local
    shards: the router on each device's tokens; the experts on every
    token (the routes gathered whole, so that the first-come slots and
    capacity are the whole batch's, as on one device) with each expert's
    d_ff over ``model`` (its output a partial sum there); the aux loss on
    the gathered routes."""
    b, s, d = x.shape
    e, ff = params["w_gate"].shape[0], params["w_gate"].shape[-1]
    on = functools.partial(pspec.placements_on, x)
    t = b * s
    rows = on(("dp", None), (t, e))
    probs, topv, topi = pspec.on_shards(
        lambda xs, router: route({"router": router}, xs, k),
        [on(("dp", None, None)), on((None, None), (d, e))],
        [rows, on(("dp", None), (t, k)), on(("dp", None), (t, k))],
        x, params["router"])
    whole = on((None, None))
    f_ax = "model" if pspec.divides(x, "model", ff) else None
    names = x.device_mesh.mesh_dim_names
    out_p = tuple(Partial() if n == "model" and f_ax else Replicate()
                  for n in names)
    out = pspec.on_shards(
        functools.partial(_experts, capacity_factor=capacity_factor),
        [on((None, None, None)), whole, whole,
         on((None, None, f_ax), params["w_gate"].shape),
         on((None, None, f_ax), params["w_up"].shape),
         on((None, f_ax, None), params["w_down"].shape)], [out_p],
        x, topv, topi, params["w_gate"], params["w_up"], params["w_down"])
    aux = pspec.on_shards(functools.partial(_aux, e=e), [whole, whole],
                          [on(())], probs, topi)
    return out, aux
