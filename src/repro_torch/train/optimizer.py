"""AdamW with global-norm clipping and a warmup + cosine schedule.

The PyTorch port's counterpart of the JAX package's ``train/optimizer.py``,
written out by hand: ``torch.optim.AdamW`` applies its decay first and
rounds in another order, so it is a different update. Moments are float32
whatever the parameter's dtype, keyed by the model's parameter names, and
placed on a DTensor parameter's mesh by ``sharding.opt_spec`` (ZeRO-1). Every
scalar of the schedule and the bias corrections is computed in float32, as
the reference computes it in float32 ``jnp``, and each elementwise step
rounds where the reference's does (no fused multiply-adds).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..configs.base import TrainConfig
from ..models.pspec import whole

Tensor = torch.Tensor
_F32 = torch.float32


@dataclasses.dataclass
class OptState:
    m: Dict[str, Tensor]
    v: Dict[str, Tensor]
    step: int = 0


def init_opt_state(params) -> OptState:
    """Zero moments in float32 beside each parameter (a ``Model`` or a
    mapping of names to tensors), on its device; a DTensor parameter's on
    its mesh, placed by ``launch.sharding.opt_spec`` (ZeRO-1)."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    m = {k: _zero_moment(k, p) for k, p in params.items()}
    return OptState(m=m, v={k: torch.zeros_like(t) for k, t in m.items()},
                    step=0)


def _zero_moment(name: str, p: Tensor) -> Tensor:
    z = torch.zeros_like(p, dtype=_F32)
    if not isinstance(z, DTensor):
        return z
    from ..launch.sharding import opt_spec

    want = opt_spec(name, p.shape, p.device_mesh)
    return z if tuple(z.placements) == want else \
        z.redistribute(p.device_mesh, want)


def _f32(x) -> Tensor:
    return torch.tensor(x, dtype=_F32)


def lr_schedule(step: int, cfg: TrainConfig) -> Tensor:
    """Linear warmup to ``learning_rate``, then a cosine down to 10 % of
    it at ``total_steps``; a float32 scalar on the host."""
    s = _f32(step)
    warm = torch.clamp_max(s / _f32(max(cfg.warmup_steps, 1)), 1.0)
    t = torch.clamp((s - _f32(cfg.warmup_steps))
                    / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                    0.0, 1.0)
    cos = _f32(0.5) * (_f32(1.0) + torch.cos(_f32(math.pi) * t))
    return _f32(cfg.learning_rate) * warm * (_f32(0.1) + _f32(0.9) * cos)


def _sum_of_squares(x: Tensor) -> Tensor:
    """sum(x^2) in float32; of a whole DTensor, not of a shard."""
    return whole(torch.sum(torch.square(x.float())))


def global_norm(tensors) -> Tensor:
    """sqrt of the sum of squares of every tensor, in float32 (of the whole
    tensors where they are DTensors: the same value on every rank)."""
    if isinstance(tensors, Mapping):
        tensors = list(tensors.values())
    sq = sum(_sum_of_squares(x) for x in tensors)
    return torch.sqrt(sq)


def adamw_update(grads: Mapping[str, Tensor], opt: OptState,
                 params: Mapping[str, Tensor], cfg: TrainConfig
                 ) -> Tuple[Dict[str, Tensor], OptState, dict]:
    """One AdamW step; returns ``(new_params, new_opt, metrics)``.

    Grads are scaled by min(1, clip / (||g|| + 1e-9)); the moments update in
    float32; ``delta = mh / (sqrt(vh) + 1e-8) + wd * p`` and the new
    parameter ``p - lr * delta`` are computed in float32 and rounded to the
    parameter's dtype. Inputs are left as they are: the new parameters and
    moments are new tensors (``apply_update`` writes them in place)."""
    names = list(params)
    step = opt.step + 1
    g = [grads[k] for k in names]
    gnorm = global_norm(g)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    lr = float(lr_schedule(step, cfg))
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = float(1.0 - torch.pow(_f32(b1), _f32(step)))
    bc2 = float(1.0 - torch.pow(_f32(b2), _f32(step)))

    g = [x.float() for x in g]
    g = torch._foreach_mul(g, scale)
    m = torch._foreach_mul([opt.m[k] for k in names], b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
    gg = torch._foreach_mul(g, 1 - b2)
    torch._foreach_mul_(gg, g)
    v = torch._foreach_mul([opt.v[k] for k in names], b2)
    torch._foreach_add_(v, gg)
    del g, gg
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, 1e-8)
    delta = torch._foreach_div(m, bc1)
    torch._foreach_div_(delta, denom)
    del denom
    p32 = [params[k].float() for k in names]
    torch._foreach_add_(delta, torch._foreach_mul(p32, cfg.weight_decay))
    torch._foreach_mul_(delta, lr)
    new = torch._foreach_sub(p32, delta)
    del delta, p32
    new_p = {k: x.to(params[k].dtype) for k, x in zip(names, new)}
    new_opt = OptState(m=dict(zip(names, m)), v=dict(zip(names, v)),
                       step=step)
    return new_p, new_opt, {"grad_norm": gnorm, "lr": lr}
