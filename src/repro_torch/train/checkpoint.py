"""Fault-tolerant checkpointing.

The PyTorch port's counterpart of the JAX package's ``train/checkpoint.py``,
in its layout: ``<dir>/step_<N:09d>/`` with one ``.npy`` per leaf and a
``manifest.json`` (each leaf's key, file, shape and dtype, and the step).
Writes go to a ``.tmp`` directory that is renamed into place, so a crash
mid-save never corrupts the latest checkpoint, and only the newest ``keep``
survive. ``AsyncCheckpointer`` copies the leaves to the host on the calling
thread and writes them on a worker, at most one save in flight.

A tree is a ``TrainState`` (its parameters under ``params``, by name, and
its optimizer state under ``opt``), an ``OptState``, or nested mappings of
tensors, arrays and ints; keys join with ``###``. Leaves are stored whole,
so ``restore(..., device=)`` puts them on any device and
``restore(..., shardings=)`` onto any mesh: the reference's elastic restore
(a checkpoint saved on a (2, 2) mesh restores onto (4, 1) or (1, 1)). A
DTensor leaf is gathered whole (``full_tensor``) by every rank of its mesh,
and one rank, rank 0 of the default process group, writes. numpy has no
bfloat16 here, so a bfloat16 leaf is stored as its raw 16 bits (``uint16``)
with ``"dtype": "bfloat16"`` in the manifest, and read back as bfloat16
from the port's files and from the reference's (whose ``np.save`` of an
``ml_dtypes`` leaf writes raw 2-byte voids under the same manifest entry).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..launch.sharding import Sharding, distribute, place_parameters
from ..models.pspec import whole
from .optimizer import OptState

_SEP = "###"


def _is_train_state(tree) -> bool:
    return hasattr(tree, "model") and isinstance(getattr(tree, "opt", None),
                                                 OptState)


def _as_mapping(tree):
    if _is_train_state(tree):
        return {"params": dict(tree.model.named_parameters()),
                "opt": tree.opt}
    if isinstance(tree, OptState):
        return {"m": tree.m, "v": tree.v, "step": tree.step}
    return tree


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    tree = _as_mapping(tree)
    if not isinstance(tree, Mapping):
        return {prefix: tree}
    out = {}
    for key, value in tree.items():
        out.update(_flatten(value, f"{prefix}{_SEP}{key}" if prefix
                            else str(key)))
    return out


def _to_host(leaf) -> tuple:
    """(numpy array, manifest dtype) of a leaf: a copy, never a view, so a
    step that then writes the parameters in place does not reach it (on the
    CPU, ``.cpu()`` and ``.numpy()`` share the leaf's storage)."""
    if isinstance(leaf, torch.Tensor):
        t = whole(leaf.detach()).to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf)
        if isinstance(leaf, (int, np.integer)):
            arr = arr.astype(np.int32)
    return arr, str(arr.dtype)


def _write(ckpt_dir: str, step: int, host: Dict[str, tuple],
           keep: int) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for i, (key, (arr, dtype)) in enumerate(host.items()):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _writes() -> bool:
    """Whether this process writes: the only one, or rank 0."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save(ckpt_dir: str, step: int, tree: Any, keep: int = 3) -> str:
    """Blocking save (every rank of a sharded tree calls it); returns the
    checkpoint path."""
    host = {k: _to_host(v) for k, v in _flatten(tree).items()}
    if not _writes():
        return os.path.join(ckpt_dir, f"step_{step:09d}")
    return _write(ckpt_dir, step, host, keep)


class AsyncCheckpointer:
    """At most one in-flight save; ``wait()`` before shutdown."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any):
        self.wait()
        # copy to the host here, so the caller may step on at once; write
        # on the worker
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        if not _writes():
            return
        self._thread = threading.Thread(
            target=_write, args=(self.ckpt_dir, step, host, self.keep),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _read(path: str, meta: dict) -> torch.Tensor:
    arr = np.load(os.path.join(path, meta["file"]))
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(np.array(arr.view(np.int16))) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _leaf(t: torch.Tensor, want, key: str, device, sharding=None) -> Any:
    """The stored leaf ``t`` checked against the target leaf ``want`` and
    placed by ``sharding`` (a ``launch.sharding.Sharding``), else as the
    target when it is a DTensor, else on ``device`` (default the target's
    device, else the host)."""
    if isinstance(want, (int, np.integer)) and not isinstance(want, bool):
        return int(t)
    want_t = want if isinstance(want, torch.Tensor) else torch.as_tensor(
        np.asarray(want)) if want is not None else None
    if want_t is not None and (tuple(t.shape) != tuple(want_t.shape)
                               or t.dtype != want_t.dtype):
        raise ValueError(f"{key}: stored {tuple(t.shape)} {t.dtype}, the "
                         f"target is {tuple(want_t.shape)} {want_t.dtype}")
    if sharding is None and isinstance(want, DTensor):
        sharding = Sharding(want.device_mesh, want.placements)
    if sharding is not None:
        return distribute(t, sharding)
    if device is None:
        device = (want.device if isinstance(want, torch.Tensor)
                  and want.device.type != "meta" else "cpu")
    return t.to(device)


def restore(ckpt_dir: str, target: Any, step: Optional[int] = None,
            device=None, shardings: Any = None) -> Any:
    """Restore the checkpoint at ``step`` (default the latest) into the
    structure of ``target``: a ``TrainState`` (the parameters written into
    its model in place, the model first moved to ``device`` if given; a
    model on the meta device is materialized there), an ``OptState``, or
    nested mappings (a new tree of tensors, each on ``device``, else on its
    target leaf's device). Every stored leaf must have its target's shape
    and dtype.

    ``shardings``: a tree of ``launch.sharding.Sharding`` in the target's
    structure (for a ``TrainState``, ``sharding.state_shardings``), whose
    leaves place the restored ones on their meshes; a ``TrainState``'s
    parameters become DTensors of theirs. Without it a DTensor target leaf
    keeps its own mesh and placements. Every rank of a mesh restores."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]

    def get(key, want, dev, sh=None):
        if key not in manifest:
            raise KeyError(f"{key}: not in the checkpoint at {path}")
        return _leaf(_read(path, manifest[key]), want, key, dev, sh)

    def build(tree, prefix: str, dev, sh):
        if isinstance(tree, OptState):
            sub = {"m": tree.m, "v": tree.v, "step": tree.step}
            got = build(sub, prefix, dev, sh)
            return OptState(m=got["m"], v=got["v"], step=got["step"])
        if isinstance(tree, Mapping):
            return {k: build(v, f"{prefix}{_SEP}{k}" if prefix else str(k),
                             dev, sh.get(k) if sh is not None else None)
                    for k, v in tree.items()}
        return get(prefix, tree, dev, sh)

    if _is_train_state(target):
        model = target.model
        dev = torch.device(device) if device is not None else model.device
        if dev.type == "meta":
            raise ValueError("the target's model is on the meta device: "
                             "restore it with an explicit device=")
        if model.device.type == "meta":
            model.to_empty(device=dev)
        elif model.device != dev:
            model.to(dev)
        sh = shardings or {}
        if sh.get("params"):
            place_parameters(model, sh["params"])
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(get(f"params{_SEP}{name}", p, dev))
        target.opt = build(target.opt, "opt", dev, sh.get("opt"))
        return target
    return build(target, "", device, shardings)


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
