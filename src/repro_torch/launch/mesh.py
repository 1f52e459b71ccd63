"""The data-parallel group and the scoring engine's shards.

The PyTorch port's counterpart of the data-parallel parts of the JAX
package's ``launch/mesh.py``. ``data_group()`` is the ``data`` axis: the
default ``torch.distributed`` process group, one rank per process, with a
one-rank world made on first use when the caller has none.
``make_data_shards(n)`` lists the cards the engine splits a batch over.

The reference's ``shard_map_compat``, ``mesh_context``, the production
(data, model) meshes and their FSDP/TP axes are JAX seams with no
counterpart here: the port shards rows over ranks or cards and keeps the
``model`` axis at size 1 (ROADMAP A8b skips ``launch/sharding.py``).
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from .. import device as _device


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


def make_data_shards(n: int, device="cuda") -> List[torch.device]:
    """The devices of ``n`` row shards: ``cuda:0`` .. ``cuda:n-1`` on the
    cards, clamped to their count; the CPU is one shard."""
    dev = _device.resolve(device)
    if dev.type != "cuda":
        return [dev]
    n = max(1, min(int(n), torch.cuda.device_count()))
    return [torch.device("cuda", i) for i in range(n)]
