"""Placement rules for parameters, optimizer state, batches and caches.

The PyTorch port's counterpart of the JAX package's ``launch/sharding.py``,
rule for rule; each ``*_spec`` returns DTensor placements, one per mesh dim
(``Shard(d)`` or ``Replicate()``), where the reference returns a
PartitionSpec. The policy:

  * the last dim of every >= 2-D weight -> ``model`` (TP) when divisible
    and at least 1,024 wide; a 1-D weight of at least 4,096 -> ``model``;
  * the second-to-last dim -> ``data`` (FSDP / ZeRO-3) in *train* mode when
    divisible and at least 1,024 wide: required to fit the 67B and 141B
    architectures' parameters and optimizer state; serving keeps TP-only
    parameters (no per-layer gather);
  * token embeddings: vocab over ``model``, d over ``data`` in train mode;
  * stacked-layer leading dims are never sharded;
  * anything indivisible is replicated on that dim.

The reference decides on its stacked (L, ...) leaves. The port keeps one
tensor per layer, ``layers.{i}.<name>`` (``convert.STACKED`` names the
stacked subtrees), and takes for it the reference's placement of the
stacked leaf with the leading L dropped: a layer's (d,) norm scale follows
the rule of the stacked (L, d) leaf (>= 1,024 on the last dim), not that of
a 1-D leaf. The L itself never enters a rule (it is the leading dim).

Batches: batch dim over ("pod", "data"). Decode KV caches: batch over
``data`` and the cache's sequence dim over ``model`` (the flash-decode
layout); SSM states: batch over ``data``, heads over ``model``.

A mesh here is a ``DeviceMesh``, or anything with its ``mesh_dim_names``
and ``shape`` (the tests pass the production meshes' geometry without a
world of 256 ranks).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, NamedTuple, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from ..models.pspec import placements
from . import mesh as mesh_lib


class Sharding(NamedTuple):
    """A mesh and one placement per mesh dim: the counterpart of the
    reference's ``NamedSharding``."""
    mesh: Any
    placements: Tuple


def _axsize(mesh, name: str) -> int:
    names = tuple(mesh.mesh_dim_names)
    return tuple(mesh.shape)[names.index(name)] if name in names else 1


def _stacked(name: str) -> Tuple[list, bool]:
    """(the reference's path keys, stacked?) of a port parameter name:
    ``layers.3.attn.wq`` -> (["layers", "attn", "wq"], True)."""
    from ..convert import STACKED

    parts = name.split(".")
    if len(parts) > 2 and parts[0] in STACKED and parts[1].isdigit():
        return [parts[0]] + parts[2:], True
    return parts, False


def param_pspec(name: str, shape, mesh, mode: str = "train") -> tuple:
    """The reference's PartitionSpec entries for the port's parameter
    ``name`` of ``shape``: per dim None or a mesh axis."""
    names, stacked = _stacked(name)
    shape = tuple(shape)
    if stacked:
        shape = (1,) + shape
    leaf = names[-1] if names else ""
    msize = _axsize(mesh, "model")
    dsize = _axsize(mesh, "data")
    fsdp = mesh_lib.fsdp_axis(mesh) if mode == "train" else None

    if leaf == "embed":
        v_ax = "model" if shape[0] % msize == 0 else None
        d_ax = fsdp if (fsdp and shape[1] % dsize == 0) else None
        return (v_ax, d_ax)

    spec = [None] * len(shape)
    if len(shape) >= 2:
        last, second = len(shape) - 1, len(shape) - 2
        if shape[last] % msize == 0 and shape[last] >= 1024:
            spec[last] = "model"
        if fsdp and shape[second] % dsize == 0 and shape[second] >= 1024 \
                and (second > 0 or not stacked):
            spec[second] = fsdp
    elif len(shape) == 1:
        if shape[0] % msize == 0 and shape[0] >= 4096:
            spec[0] = "model"
    return tuple(spec[1:] if stacked else spec)


def param_spec(name: str, shape, mesh, mode: str = "train") -> tuple:
    """Placements of the parameter ``name`` of ``shape``."""
    return placements(param_pspec(name, shape, mesh, mode),
                      mesh.mesh_dim_names)


def param_shardings(model: nn.Module, mesh,
                    mode: str = "train") -> Dict[str, Sharding]:
    """{parameter name: ``Sharding``} of every parameter of ``model``."""
    return {n: Sharding(mesh, param_spec(n, p.shape, mesh, mode))
            for n, p in model.named_parameters()}


def dp_size(mesh) -> int:
    """Ranks the batch is split over: the product of the data axes."""
    return math.prod(_axsize(mesh, a) for a in mesh_lib.dp_axes(mesh))


def batch_pspec(name: str, shape, mesh) -> tuple:
    dp, n_dp = mesh_lib.dp_axes(mesh), dp_size(mesh)
    if name == "positions" and len(shape) == 3:   # (3, B, S) M-RoPE
        return (None, dp if shape[1] % n_dp == 0 else None, None)
    spec = [None] * len(shape)
    if len(shape) and shape[0] % n_dp == 0:
        spec[0] = dp
    return tuple(spec)


def batch_spec(name: str, shape, mesh) -> tuple:
    """Placements of the batch leaf ``name``: dim 0 over the data axes
    (dim 1 of M-RoPE positions)."""
    return placements(batch_pspec(name, shape, mesh), mesh.mesh_dim_names)


def batch_shardings(batch: Mapping[str, Any], mesh) -> Dict[str, Sharding]:
    return {k: Sharding(mesh, batch_spec(k, tuple(v.shape), mesh))
            for k, v in batch.items()}


def cache_pspec(name: str, shape, mesh) -> tuple:
    msize = _axsize(mesh, "model")
    dsize = _axsize(mesh, "data")
    if name == "length":
        return (None,)
    spec = [None] * len(shape)
    if len(shape) >= 2 and shape[1] % dsize == 0:
        spec[1] = "data"
    if name in ("k", "v", "xk", "xv") and len(shape) == 5:
        if shape[2] % msize == 0:
            spec[2] = "model"
    elif name == "state" and len(shape) == 5:
        if shape[2] % msize == 0:
            spec[2] = "model"
    elif name == "conv" and len(shape) == 4:
        if shape[3] % msize == 0:
            spec[3] = "model"
    return tuple(spec)


def cache_spec(name: str, shape, mesh) -> tuple:
    """Placements of the decode-cache field ``name``: (L, B, S, KH, hd)
    K/V -> batch over data, seq over model; SSM states (L, B, H, hd, N) ->
    batch over data, heads over model; conv tails (L, B, W-1, C) -> batch
    over data, channels over model; ``length`` replicated."""
    return placements(cache_pspec(name, shape, mesh), mesh.mesh_dim_names)


def cache_shardings(cache, mesh):
    """The cache's NamedTuple with a ``Sharding`` in every field."""
    return type(cache)(*(Sharding(mesh, cache_spec(n, tuple(t.shape), mesh))
                         for n, t in zip(cache._fields, cache)))


def opt_spec(name: str, shape, mesh) -> tuple:
    """ZeRO-1: the moments take the parameter's train-mode placements (the
    FSDP dim already spreads them over data)."""
    return param_spec(name, shape, mesh, mode="train")


def replicated(mesh) -> Sharding:
    return Sharding(mesh, (Replicate(),) * len(mesh.mesh_dim_names))


def distribute(t: torch.Tensor, sharding: Sharding) -> DTensor:
    """``t``, which every rank holds whole and alike, as a DTensor of
    ``sharding``: each rank keeps its own shard, nothing is sent."""
    mesh = sharding.mesh
    if t.device.type != "meta":
        t = t.to(mesh.device_type)
    return distribute_tensor(t, mesh, list(sharding.placements),
                             src_data_rank=None)


def place_parameters(model: nn.Module,
                     shardings: Mapping[str, Sharding]) -> nn.Module:
    """Replace each named parameter of ``model`` by a DTensor parameter of
    its ``Sharding`` holding the same values (and the same ``init_scale``
    / ``init_value``); returns ``model``."""
    for name, sh in shardings.items():
        owner, _, leaf = name.rpartition(".")
        parent = model.get_submodule(owner) if owner else model
        p = getattr(parent, leaf)
        new = nn.Parameter(distribute(p.detach(), sh),
                           requires_grad=p.requires_grad)
        for attr in ("init_scale", "init_value"):
            if hasattr(p, attr):
                setattr(new, attr, getattr(p, attr))
        setattr(parent, leaf, new)
    return model


def state_shardings(model: nn.Module, mesh, mode: str = "train") -> dict:
    """A ``TrainState``'s shardings for ``checkpoint.restore``: the
    parameters' in ``mode`` and the moments' (``opt_spec``)."""
    opt = {n: Sharding(mesh, opt_spec(n, p.shape, mesh))
           for n, p in model.named_parameters()}
    return {"params": param_shardings(model, mesh, mode),
            "opt": {"m": opt, "v": dict(opt)}}


def shard_model(model: nn.Module, mesh, mode: str = "train") -> nn.Module:
    """Turn every parameter of ``model`` into a DTensor ``nn.Parameter``
    placed by ``param_spec`` in ``mode`` ("train": FSDP and TP; "serve":
    TP only); returns ``model``. Every rank must hold the same weights."""
    return place_parameters(model, param_shardings(model, mesh, mode))


def shard_cache(cache, mesh):
    """The decode cache as DTensors of ``cache_shardings``."""
    return type(cache)(*(distribute(t, sh) for t, sh in
                         zip(cache, cache_shardings(cache, mesh))))


def local_bytes(tensors) -> int:
    """Bytes one rank holds of ``tensors`` (a DTensor's local shard)."""
    return sum(t.to_local().numel() * t.element_size()
               if isinstance(t, DTensor) else t.numel() * t.element_size()
               for t in tensors)
