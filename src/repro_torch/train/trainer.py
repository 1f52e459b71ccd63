"""Training step factory: loss -> grads (with optional microbatch
accumulation) -> clip -> AdamW, as one function of ``(TrainState, batch)``.

The PyTorch port's counterpart of the JAX package's ``train/trainer.py``.
The state is the ``Model`` (its parameters, the Cox head among them once
``deep.init_state`` has attached it) and its ``OptState``; a step takes its
grads through ``torch.autograd``, writes the new parameters into the model
in place and returns the same state. A parameter the objective does not
reach gets a zero gradient, as ``jax.grad`` gives it. A model whose
parameters are DTensors (``launch.sharding.shard_model``) steps on its
mesh: the batch (each microbatch by itself) is sharded over the data
axes, and the loss and metrics are gathered whole on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..configs.base import TrainConfig
from ..data.pipeline import put_batch
from ..models import pspec
from ..models.model import Model
from . import optimizer as opt_lib

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainState:
    model: Model
    opt: opt_lib.OptState


def init_train_state(model: Model, gen: torch.Generator) -> TrainState:
    """Draw the model's weights from ``gen`` and wrap them with zero
    moments."""
    model.reset_parameters(gen)
    return TrainState(model=model, opt=opt_lib.init_opt_state(model))


def make_loss_fn(model: Model, objective: str = "lm",
                 remat=True) -> Callable:
    """``loss_fn(batch, m=model) -> (loss, aux metrics)`` of ``objective``
    on ``m``'s current parameters: ``"lm"`` (``Model.loss_lm`` with
    ``remat``) or ``"cox"`` (``head.cox_loss``, which rematerializes as the
    reference's does)."""
    if objective == "lm":
        def loss_fn(batch, m=model):
            return m.loss_lm(batch, remat=remat)
    elif objective == "cox":
        from ..survival import head as head_lib

        def loss_fn(batch, m=model):
            return head_lib.cox_loss(m, batch)
    else:
        raise ValueError(objective)
    return loss_fn


def _batch_target(m: Model):
    """Where a step's batch goes: the mesh of a model whose parameters are
    DTensors (``sharding.shard_model``), else the model's device."""
    return m.embed.device_mesh if isinstance(m.embed, DTensor) else m.device


def _grads(loss: Tensor, params: Dict[str, Tensor]) -> Dict[str, Tensor]:
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), got)}


def _microbatches(batch, k: int, target) -> list:
    """The ``k`` microbatches of ``batch``: rows i*B/k .. (i+1)*B/k - 1 of
    every leaf, as the reference's reshape (k, B/k, ...) takes them, on
    ``target`` (a device or a mesh). On a mesh each is placed by itself,
    so its own rows split over the data axes (row blocks of a batch placed
    whole would each sit on one data rank); a microbatch that does not
    split evenly over them raises."""
    def split(v):
        return v.reshape(k, v.shape[0] // k, *v.shape[1:])

    if not isinstance(target, DeviceMesh):
        b = {n: split(v) for n, v in put_batch(batch, target).items()}
        return [{n: v[i] for n, v in b.items()} for i in range(k)]
    from ..launch.sharding import dp_size

    b = {n: split(pspec.whole(v)) for n, v in batch.items()}
    rows, n_dp = next(iter(b.values())).shape[1], dp_size(target)
    if rows % n_dp:
        raise ValueError(
            f"a microbatch of {rows} rows (the batch over microbatch={k}) "
            f"does not split over the mesh's {n_dp} data-parallel ranks")
    return [put_batch({n: v[i] for n, v in b.items()}, target)
            for i in range(k)]


def make_train_step(model: Model, tcfg: TrainConfig,
                    objective: str = "lm") -> Callable:
    """``train_step(state, batch) -> (state, metrics)`` for ``model``. The
    batch is a host (numpy) or device batch; it moves to the model's
    device. With ``tcfg.microbatch > 1`` dim 0 splits into that many
    chunks, whose grads add in float32 and, with the loss, divide by the
    count; the metrics are then the loss and the optimizer's only. The
    step runs on ``state.model``, ``model`` or one restored in its place."""
    loss_fn = make_loss_fn(model, objective, remat=tcfg.remat)

    def train_step(state: TrainState, batch) -> tuple:
        m = state.model
        params = dict(m.named_parameters())
        if tcfg.microbatch > 1:
            k = tcfg.microbatch
            grads = {n: torch.zeros_like(p, dtype=torch.float32)
                     for n, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=m.device)
            for mb in _microbatches(batch, k, _batch_target(m)):
                loss_i = pspec.whole(loss_fn(mb, m)[0])
                for n, g in _grads(loss_i, params).items():
                    grads[n] = grads[n] + g
                loss = loss + loss_i.detach()
            grads = {n: g / k for n, g in grads.items()}
            loss = loss / k
            metrics: Dict[str, Tensor] = {}
        else:
            loss, metrics = loss_fn(put_batch(batch, _batch_target(m)), m)
            loss = pspec.whole(loss)
            grads = _grads(loss, params)
            loss = loss.detach()
            metrics = {n: pspec.whole(v).detach()
                       for n, v in metrics.items()}
        new_p, state.opt, opt_metrics = opt_lib.adamw_update(
            grads, state.opt, {n: p.detach() for n, p in params.items()},
            tcfg)
        del grads
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(new_p[n])
        return state, {"loss": loss, **metrics, **opt_metrics}

    return train_step
