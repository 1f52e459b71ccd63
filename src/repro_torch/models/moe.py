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

``sparse_moe`` is the layer of Nemotron-H and Kimi Linear, the port's own:
a sigmoid router whose choice adds a correction bias and whose weights
(the plain scores of the chosen) are normalised and scaled, no aux loss;
every (token, choice) pair dispatched, none dropped, over the pairs sorted
by expert, through one grouped GEMM an expert projection
(``F.grouped_mm``); relu^2 experts (Nemotron-H) or SwiGLU ones (Kimi);
one shared expert on every token. The layer may hold a share of the
experts (expert parallelism): it routes over all of them and computes
only the pairs of the experts it holds.
"""
from __future__ import annotations

import functools
from typing import Callable, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate

from ..obs import trace
from . import pspec
from .layers import const, normal

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


# ---------------------------------------------------------------------------
# Nemotron-H: sigmoid router, no drops, relu^2 experts, a shared expert
# ---------------------------------------------------------------------------

def init_sparse_moe(d_model: int, d_ff: int, n_experts: int, shared_d_ff: int,
                    dtype=torch.bfloat16, device="cuda", held: int = 0,
                    gated: bool = False) -> nn.ParameterDict:
    """The router over ``n_experts``, the weights of ``held`` of them (all
    when 0) and the shared expert; ``gated``: SwiGLU experts, a gate
    projection beside each up projection."""
    s = d_model ** -0.5
    n = held or n_experts
    p = {
        "router": normal((d_model, n_experts), s, torch.float32, device),
        # the choice's correction bias (``e_score_correction_bias``)
        "router_bias": const(torch.zeros(n_experts), device),
        "w_up": normal((n, d_model, d_ff), s, dtype, device),
        "w_down": normal((n, d_ff, d_model), d_ff ** -0.5, dtype, device),
        "shared_up": normal((d_model, shared_d_ff), s, dtype, device),
        "shared_down": normal((shared_d_ff, d_model), shared_d_ff ** -0.5,
                              dtype, device),
    }
    if gated:
        p["w_gate"] = normal((n, d_model, d_ff), s, dtype, device)
        p["shared_gate"] = normal((d_model, shared_d_ff), s, dtype, device)
    return nn.ParameterDict(p)


def route_sigmoid(params: Mapping[str, Tensor], x: Tensor, k: int,
                  scaling: float = 1.0, norm_topk_prob: bool = True):
    """The sigmoid router: (weights (T, k) float32, experts (T, k)) for the
    T = B * S tokens of x (B, S, D). The top k of score + bias choose; the
    chosen plain scores, over their sum when ``norm_topk_prob``, times
    ``scaling``, weigh."""
    xt = x.reshape(-1, x.shape[-1])
    scores = torch.sigmoid(xt.float() @ params["router"])
    topi = torch.topk(scores + params["router_bias"], k, dim=-1).indices
    topv = scores.gather(1, topi)
    if norm_topk_prob:
        topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-20)
    return topv * scaling, topi


def _relu2(h: Tensor) -> Tensor:
    return torch.square(torch.relu(h))


def _mlp(x: Tensor, up, down, gate=None, mm=torch.matmul) -> Tensor:
    """relu(x up)^2 down, or with ``gate`` silu(x gate) (x up) down; ``mm``
    the projection (a grouped GEMM over the experts' row ranges)."""
    h = mm(x, up)
    h = _relu2(h) if gate is None else F.silu(mm(x, gate)) * h
    return mm(h, down)


def expert_load(topi: Tensor, n_experts: int) -> Tensor:
    """The (token, choice) pairs each expert takes, (E,), with no host
    read (``torch.bincount`` reads its input's largest value on the host
    first)."""
    flat = topi.reshape(-1)
    return torch.zeros(n_experts, dtype=flat.dtype, device=flat.device) \
        .index_add_(0, flat, torch.ones_like(flat))


def sorted_experts(x: Tensor, topv: Tensor, topi: Tensor, load: Tensor,
                   w_up: Tensor, w_down: Tensor,
                   w_gate: Optional[Tensor] = None) -> Tensor:
    """Every (token, choice) pair through its expert (relu^2, or SwiGLU
    given ``w_gate``), none dropped: x (T, D), topv and topi (T, k),
    ``expert_load(topi)`` -> the sum over k of weight x expert output (T,
    D), float32. The pairs are sorted by expert (stable, so by token
    within one), gathered, run through one grouped GEMM an expert
    projection over the experts' row ranges (no host read), put back in
    pair order and summed over the choices in a fixed order."""
    t, k = topi.shape
    order = torch.argsort(topi.reshape(t * k), stable=True)
    ends = torch.cumsum(load, 0, dtype=torch.int32)
    mm = functools.partial(F.grouped_mm, offs=ends)
    ys = _mlp(x[order // k], w_up, w_down, w_gate, mm)          # (T k, D)
    back = torch.empty_like(ys)
    back[order] = ys
    return (back.reshape(t, k, -1).float() * topv[..., None]).sum(dim=1)


def _read_later(t: Tensor) -> Callable[[], int]:
    """A one-element tensor's value, its copy to the host started now on
    the card: the returned call waits for that copy alone, so work queued
    after this runs on while the host waits."""
    if not t.is_cuda:
        return lambda: int(t)
    host = t.to("cpu", non_blocking=True)
    copied = torch.cuda.Event()
    copied.record()

    def wait() -> int:
        copied.synchronize()
        return int(host)
    return wait


def held_experts(x: Tensor, topv: Tensor, local: Tensor, load: Tensor,
                 w_up: Tensor, w_down: Tensor,
                 w_gate: Optional[Tensor] = None,
                 count: Optional[Callable[[], int]] = None) -> Tensor:
    """The pairs whose expert this layer holds through their experts, as
    ``sorted_experts`` does: x (T, D); topv (T, k); local (T, k), the
    chosen experts' ids less the first held one's; load (n,), the held
    experts' pairs -> the sum over each token's held choices of weight x
    expert output (T, D), float32. The other pairs are neither gathered
    nor computed: their experts' part of the result is another card's.
    The number of held pairs, read on the host once a call, sizes the
    buffers, as an expert-parallel layer's exchange learns what it
    receives; ``count`` is that read when the caller has started it
    (``_read_later(load.sum())``), else it starts here. Each token's held
    outputs are summed in choice order (``torch.segment_reduce``: no
    atomics, the same bits every run)."""
    t, k = local.shape
    n = w_up.shape[0]
    ends = torch.cumsum(load, 0, dtype=torch.int32)
    count = count or _read_later(ends[-1])
    flat = local.reshape(t * k)
    held = (flat >= 0) & (flat < n)
    # the held pairs first, by expert, and by pair within one
    pairs = torch.argsort(torch.where(held, flat, n), stable=True)
    lengths = held.reshape(t, k).sum(1)
    m = count()
    if m == 0:
        return x.new_zeros(t, x.shape[1], dtype=torch.float32)
    pairs = pairs[:m]
    mm = functools.partial(F.grouped_mm, offs=ends)
    ys = _mlp(x[pairs // k], w_up, w_down, w_gate, mm)           # (m, D)
    by_pair, back = torch.sort(pairs)
    ys = ys[back].float() * topv.reshape(t * k)[by_pair, None]
    return torch.segment_reduce(ys, "sum", lengths=lengths, axis=0,
                                unsafe=True)


def sparse_moe(params: Mapping[str, Tensor], x: Tensor, k: int,
               scaling: float = 1.0, norm_topk_prob: bool = True,
               first: int = 0) -> Tensor:
    """x: (B, S, D), pre-normed -> the routed experts' weighted sum plus
    the shared expert, (B, S, D) in x's dtype. The router scores its E
    experts; the layer holds the weights of n of them, ids ``first`` to
    ``first + n - 1``, and where n < E computes only their pairs
    (``held_experts``), else every pair (``sorted_experts``). Experts and
    the shared expert are SwiGLU where ``params`` has ``w_gate``, else
    relu^2. Spans with the card's time: ``moe.route`` (attributes
    ``tokens``; ``max_load``, the most pairs one expert took, and
    ``held_pairs``, the pairs sent to held experts, card tensors read when
    the span is written out, or a number where every expert is held),
    ``moe.experts`` (the sort, the grouped GEMMs, the combine) and
    ``moe.shared``. Where every expert is held the path reads nothing on
    the host; else the held pairs' count comes to the host, and
    ``moe.shared`` runs before ``moe.experts`` to keep the card busy while
    it does."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    e, n = params["router"].shape[1], params["w_up"].shape[0]
    gate = params["w_gate"] if "w_gate" in params else None
    shared_gate = params["shared_gate"] if gate is not None else None
    with trace.span("moe.route", device_time=True, tokens=b * s) as sp:
        topv, topi = route_sigmoid(params, x, k, scaling, norm_topk_prob)
        load = expert_load(topi, e)
        sp.set(max_load=load.max())
        if n < e:
            load = load[first:first + n]
            pairs = load.sum()
            sp.set(held_pairs=pairs)
            count = _read_later(pairs)
        else:
            sp.set(held_pairs=b * s * k)
    if n < e:
        # the shared expert first: the card runs it while the host waits
        # for the held pairs' count
        with trace.span("moe.shared", device_time=True):
            shared = _mlp(xt, params["shared_up"], params["shared_down"],
                          shared_gate)
        with trace.span("moe.experts", device_time=True):
            routed = held_experts(xt, topv, topi - first, load,
                                  params["w_up"], params["w_down"], gate,
                                  count)
            out = (routed + shared.float()).to(x.dtype)
        return out.reshape(b, s, d)
    with trace.span("moe.experts", device_time=True):
        routed = sorted_experts(xt, topv, topi, load, params["w_up"],
                                params["w_down"], gate)
    with trace.span("moe.shared", device_time=True):
        shared = _mlp(xt, params["shared_up"], params["shared_down"],
                      shared_gate)
        out = (routed + shared.float()).to(x.dtype)
    return out.reshape(b, s, d)
