"""Meshes: the production (data, model) meshes, the ambient mesh, the
data-parallel group and the scoring engine's shards.

The PyTorch port's counterpart of the JAX package's ``launch/mesh.py``. A
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, one rank per card. ``make_production_mesh``
builds the reference's (16, 16) ``("data", "model")`` mesh, or (2, 16, 16)
with a leading ``"pod"`` axis, and fails unless the world has exactly that
many ranks. ``mesh_context(mesh)`` makes a mesh ambient for
``models/pspec.py``'s activation anchors: a context variable the port holds
itself, which is the whole of what the reference's ``models/compat.py``
probes JAX for. ``data_group()`` is the ``data`` axis of a one-axis world:
the default process group, made first as a one-rank world when the caller
has none. ``make_data_shards(n)`` lists the cards the engine splits a batch
over.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import device as _device

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}

_AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


def data_group(device="cuda"):
    """The default process group, made first as a one-rank world when
    none exists: ``nccl`` for a card, ``gloo`` for the CPU (an in-process
    store, no address)."""
    if not dist.is_initialized():
        dev = _device.resolve(device)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.group.WORLD


def world_size() -> int:
    """Ranks of the default process group; 1 when there is none."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the named ``axes`` on the ranks of
    the default process group (a one-rank world made first when there is
    none and the mesh has one device). Each rank of a ``cuda`` mesh takes
    the card of its local rank."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if not dist.is_initialized() and math.prod(shape) == 1:
        data_group(device_type)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's (16, 16) ``("data", "model")`` mesh, or (2, 16, 16)
    ``("pod", "data", "model")``; raises unless the world has exactly its
    256 (512) ranks."""
    shape, axes = PRODUCTION[bool(multi_pod)]
    need, have = math.prod(shape), world_size()
    if have != need:
        raise ValueError(
            f"the production mesh {' x '.join(map(str, shape))} over "
            f"{axes} needs a world of {need} ranks; this one has {have}")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(device_type: str = "cuda"):
    """The (1, 1) ``("data", "model")`` mesh of one device."""
    return make_mesh((1, 1), ("data", "model"), device_type)


def dp_axes(mesh) -> tuple:
    """Axes the batch is sharded over."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def fsdp_axis(mesh) -> str:
    """Axis weights and optimizer state are FSDP-sharded over (in-pod only:
    gathering weights across pods would dominate the step)."""
    return "data"


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` ambient for the block (``current_mesh``)."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def current_mesh() -> Optional[object]:
    """The ambient mesh, or None outside every ``mesh_context``."""
    return _AMBIENT.get()


def make_data_shards(n: int, device="cuda") -> List[torch.device]:
    """The devices of ``n`` row shards: ``cuda:0`` .. ``cuda:n-1`` on the
    cards, clamped to their count; the CPU is one shard."""
    dev = _device.resolve(device)
    if dev.type != "cuda":
        return [dev]
    n = max(1, min(int(n), torch.cuda.device_count()))
    return [torch.device("cuda", i) for i in range(n)]

