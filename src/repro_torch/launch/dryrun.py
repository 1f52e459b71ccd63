"""Dry run of every (architecture x shape) cell on the meta device, for
one NVIDIA H100 or a mesh of them.

    python -m repro_torch.launch.dryrun [--arch a,b] [--shape s,t]
        [--mesh single|multi|both] [--out build/dryrun_torch] [--skip-done]

The PyTorch port's counterpart of the JAX package's ``launch/dryrun.py``,
which lowers each cell over a TPU mesh and reads XLA's cost analysis. Here
each cell's ``Model`` is built on ``torch.device("meta")``, where tensors
have shapes and dtypes and no storage, and nothing runs on a card:

- the FLOPs of one step, counted by ``torch.utils.flop_counter.
  FlopCounterMode`` (matrix products; elementwise work is not counted):
  for ``train`` the forward, the ``torch.autograd`` backward (with the
  layers' recompute under remat) and ``adamw_update``; for ``prefill``
  ``Model.prefill``; for ``decode`` one ``Model.decode_step`` on an
  ``init_cache_specs`` cache. They are counted at depth 1 and 2 with
  single-chunk attention and extrapolated linearly in depth
  (``analysis_config``), which keeps 32k blocked-attention loops and deep
  stacks out of the count's Python time;
- the bytes of the state: the parameters in the config's dtype, for
  ``train`` their gradients and the two float32 moments, the cache and
  the inputs, and whether they fit in the card's memory (its
  ``total_memory`` when a card is present, else the H100's 80 GB; the
  record says which). Activations and temporaries are not counted;
- the roofline of ``analysis/roofline.py`` on one card, no collective
  term; its memory term is a floor (``memory_floor_bytes``): the state
  the step must read and write once.

With ``--mesh``, each cell runs instead on the reference's production
mesh, 16 x 16 ``("data", "model")`` (``single``) or 2 x 16 x 16 with a
``"pod"`` axis (``multi``), in a process that makes a fake world of 256 or
512 ranks (``torch``'s ``"fake"`` process group: its collectives move
nothing). The process is rank 0 of that world. Its model is built on meta
and sharded by ``launch/sharding.py`` (``train`` mode for train cells,
``serve`` for prefill and decode), its batch and decode cache too, and:

- the state bytes are one device's, summed over the local shards, with
  ``fits`` against one card;
- the FLOPs are one device's: the matrix products that DTensor runs on the
  local shards (``torch.utils.flop_counter``'s formulas), at depth 1 and 2
  as on one card;
- the collectives are one device's, recorded under ``CommDebugMode`` (op,
  output bytes, group size) at the same depths, extrapolated alike and
  turned into bytes by ``roofline.collectives_from_comm_counts``;
- the roofline has the mesh's device count and the link term at the
  cross-node rate (``roofline.CROSS_NODE_BYTES_PER_S``).

One JSON a cell goes to ``--out`` (``build/dryrun_torch/``), as
``{arch}_{shape}.json`` on one card and ``{arch}_{shape}_{mesh}.json`` on
a mesh; ``analysis/report.py`` renders them.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.debug._comm_mode import c10d_collective_ops
from torch.utils import _pytree as pytree
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from ..analysis import roofline as rl
from ..configs import (REGISTRY, SHAPES, TrainConfig, applicable_shapes,
                       get_config)
from ..data.pipeline import put_batch
from ..models.model import Model
from ..train import optimizer as opt_lib
from ..train.trainer import TrainState, make_train_step
from . import mesh as mesh_lib, sharding

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun_torch")
TARGET = "H100 x1"
H100_BYTES = 80e9            # NVIDIA H100 SXM5 data sheet, HBM3
META = torch.device("meta")


def analysis_config(cfg, shape, depth_units: int):
    """Variant used ONLY for FLOP accounting: ``depth_units`` layers (a
    hybrid's unit is one group of mamba layers and the shared block; an
    encoder-decoder's is one encoder and one decoder layer) and
    single-chunk attention (q/kv chunks = seq), so that the count runs one
    attention block and the step at depth L is
        f(L) = f(1) + (L - 1) * (f(2) - f(1)),
    exact because every layer of a unit has the same shapes."""
    big = max(shape.seq_len, 1)
    kw = dict(q_chunk=big, kv_chunk=big)
    if cfg.family == "hybrid":
        kw["n_layers"] = cfg.shared_attn_every * depth_units
    else:
        kw["n_layers"] = depth_units
        if cfg.encoder_layers:
            kw["encoder_layers"] = depth_units
    return cfg.scaled(**kw)


def depth_units_of(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    return cfg.n_layers


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _step(model, shape, batch, cache=None, tcfg=None) -> None:
    """One step of ``shape.kind`` on ``model``: a train step, a prefill, or
    one decode step on ``cache`` (default ``init_cache_specs``)."""
    if shape.kind == "train":
        state = TrainState(model=model, opt=opt_lib.init_opt_state(model))
        make_train_step(model, tcfg or TrainConfig())(state, batch)
    elif shape.kind == "prefill":
        model.prefill(batch, max_len=shape.seq_len)
    else:
        if cache is None:
            cache = model.init_cache_specs(shape.global_batch, shape.seq_len)
        model.decode_step(cache, batch["tokens"])


def count_flops(cfg, shape, tcfg=None) -> float:
    """FLOPs of one step of ``shape.kind`` for ``cfg``, on meta tensors."""
    model = Model(cfg, device=META)
    batch = model.make_input_specs(shape)
    with FlopCounterMode(display=False) as counter:
        _step(model, shape, batch, tcfg=tcfg)
    return float(counter.get_total_flops())


def probe_flops(cfg, shape) -> dict:
    """{depth units: FLOPs} at depth 1 and 2 of ``analysis_config``."""
    return {u: count_flops(analysis_config(cfg, shape, u), shape)
            for u in (1, 2)}


def extrapolate(probes: dict, units: int) -> float:
    return probes[1] + (units - 1) * (probes[2] - probes[1])


def state_bytes(cfg, shape) -> dict:
    """Bytes of the cell's state, from the full-depth model on meta."""
    model = Model(cfg, device=META)
    params = list(model.parameters())
    n = sum(p.numel() for p in params)
    out = {"n_params": n, "params": _nbytes(params), "grads": 0,
           "moments": 0, "cache": 0,
           "inputs": _nbytes(model.make_input_specs(shape).values())}
    if shape.kind == "train":
        out["grads"] = out["params"]
        out["moments"] = 2 * 4 * n
    else:
        out["cache"] = _nbytes(model.init_cache_specs(shape.global_batch,
                                                      shape.seq_len))
    out["opt"] = out["grads"] + out["moments"]
    out["state"] = out["params"] + out["opt"] + out["cache"] + out["inputs"]
    return out


def memory_floor(b: dict, kind: str) -> int:
    """Bytes a step must move at least: a train step reads and writes the
    parameters, the gradients and the moments once and reads the inputs;
    a prefill reads the parameters and inputs and writes the cache; a
    decode step reads the parameters, the cache and its inputs."""
    if kind == "train":
        return 2 * (b["params"] + b["grads"] + b["moments"]) + b["inputs"]
    return b["params"] + b["cache"] + b["inputs"]


def card_memory() -> tuple:
    """(bytes, where the figure comes from)."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return props.total_memory, f"total_memory of {props.name}"
    return H100_BYTES, "H100 SXM5 data sheet (no card present)"


def _skip_reason(cfg, shape_name: str):
    for s, reason in applicable_shapes(cfg):
        if s.name == shape_name:
            return reason
    raise KeyError(shape_name)


def run_cell(arch: str, shape_name: str, out_dir: str = OUT_DIR,
             cfg_override=None) -> dict:
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "target": TARGET,
           "status": "ok"}
    reason = _skip_reason(cfg, shape_name)
    if reason is not None:
        rec.update(status="skipped", reason=reason)
        _write(rec, out_dir)
        return rec
    t0 = time.time()
    try:
        b = state_bytes(cfg, shape)
        card_bytes, card = card_memory()
        probes = probe_flops(cfg, shape)
        units = depth_units_of(cfg)
        flops = extrapolate(probes, units)
        floor = memory_floor(b, shape.kind)
        mf = rl.model_flops_for(cfg, shape, rl.active_params(cfg))
        roof = rl.compute_roofline(flops, floor, rl.NO_COLLECTIVES, 1, mf)
        rec.update(
            bytes=b, card_bytes=card_bytes, card=card,
            fits=b["state"] <= card_bytes, flops=flops,
            probe_flops={str(u): f for u, f in probes.items()},
            depth_units=units, memory_floor_bytes=floor,
            roofline=roof.to_json())
    except Exception:
        rec["status"] = "error"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    _write(rec, out_dir)
    return rec


def _path(out_dir: str, arch: str, shape_name: str, mesh=None) -> str:
    tail = f"_{mesh}" if mesh else ""
    return os.path.join(out_dir, f"{arch}_{shape_name}{tail}.json")


def _write(rec: dict, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    with open(_path(out_dir, rec["arch"], rec["shape"], rec.get("mesh")),
              "w") as f:
        json.dump(rec, f, indent=1)


# ---------------------------------------------------------------------------
# The mesh dry run: a fake world, DTensor on meta
# ---------------------------------------------------------------------------

MESH_NAMES = {False: "pod16x16", True: "pod2x16x16"}


def fake_world(n_ranks: int) -> None:
    """Make this process rank 0 of a fake world of ``n_ranks`` (torch's
    ``"fake"`` process group, whose collectives move nothing)."""
    import torch.distributed as dist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the mesh dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            f"torch {torch.__version__} lacks") from e
    if dist.is_initialized():
        raise RuntimeError("the mesh dry run makes a fake world of its own: "
                           "run it in a process without a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)


class MeshCounts(CommDebugMode):
    """``CommDebugMode`` that also records what one device runs: each
    collective as (op, output bytes, group size), and the FLOPs of the
    matrix products on local shards (an op on DTensors passes through to
    DTensor, which runs it on local tensors; the fake tensors of its
    sharding propagation are not counted)."""

    def __init__(self):
        super().__init__()
        self.records: list = []
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or not hasattr(func, "_overloadpacket"):
            return out
        packet = func._overloadpacket
        if packet in self.comm_registry or packet in c10d_collective_ops:
            outs = [t for t in pytree.tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            self.records.append((
                str(packet), sum(t.numel() * t.element_size() for t in outs),
                _group_size(args, kwargs)))
        elif packet in flop_registry and not any(
                isinstance(a, FakeTensor) for a in pytree.tree_leaves(args)):
            self.flops += flop_registry[packet](*args, **(kwargs or {}),
                                                out_val=out)
        return out


def _group_size(args, kwargs) -> int:
    """Ranks of the group a collective names (its ``group_name``)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in list(args) + list((kwargs or {}).values()):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (RuntimeError, ValueError, KeyError):
                continue
        if isinstance(a, dist.ProcessGroup):
            return a.size()
    return dist.get_world_size()


def _sharded(cfg, shape, mesh, full_state: bool):
    """(model, batch, cache or None) of a cell on meta, sharded on
    ``mesh``; the decode cache at full depth only when ``full_state``."""
    model = Model(cfg, device=META)
    sharding.shard_model(model, mesh,
                         "train" if shape.kind == "train" else "serve")
    batch = put_batch(model.make_input_specs(shape), mesh)
    cache = None
    if shape.kind == "decode" or (full_state and shape.kind == "prefill"):
        cache = sharding.shard_cache(
            model.init_cache_specs(shape.global_batch, shape.seq_len), mesh)
    return model, batch, cache


def mesh_state_bytes(cfg, shape, mesh) -> dict:
    """One device's bytes of the cell's state on ``mesh``: local shards of
    the parameters, for train their gradients and float32 moments (ZeRO-1:
    the moments take the parameters' placements), the cache and inputs."""
    model, batch, cache = _sharded(cfg, shape, mesh, full_state=True)
    params = list(model.parameters())
    local = sum(p.to_local().numel() for p in params)
    out = {"n_params": sum(p.numel() for p in params),
           "n_params_local": local,
           "params": sharding.local_bytes(params), "grads": 0, "moments": 0,
           "cache": 0, "inputs": sharding.local_bytes(batch.values())}
    if shape.kind == "train":
        out["grads"] = out["params"]
        out["moments"] = 2 * 4 * local
    else:
        out["cache"] = sharding.local_bytes(cache)
    out["opt"] = out["grads"] + out["moments"]
    out["state"] = out["params"] + out["opt"] + out["cache"] + out["inputs"]
    return out


def mesh_probe(cfg, shape, mesh) -> tuple:
    """(FLOPs, collective records) of one device's step of ``cfg``."""
    model, batch, cache = _sharded(cfg, shape, mesh, full_state=False)
    with mesh_lib.mesh_context(mesh), MeshCounts() as counts:
        _step(model, shape, batch, cache)
    return counts.flops, counts.records


def run_mesh_cell(arch: str, shape_name: str, multi_pod: bool, mesh,
                  out_dir: str = OUT_DIR) -> dict:
    """One cell on the production mesh ``mesh`` of a fake world."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_dev = mesh.size()
    rec = {"arch": arch, "shape": shape_name, "mesh": MESH_NAMES[multi_pod],
           "target": f"H100 x{n_dev}", "status": "ok"}
    reason = _skip_reason(cfg, shape_name)
    if reason is not None:
        rec.update(status="skipped", reason=reason)
        _write(rec, out_dir)
        return rec
    t0 = time.time()
    try:
        b = mesh_state_bytes(cfg, shape, mesh)
        card_bytes, card = card_memory()
        probes = {u: mesh_probe(analysis_config(cfg, shape, u), shape, mesh)
                  for u in (1, 2)}
        units = depth_units_of(cfg)
        flops = extrapolate({u: f for u, (f, _) in probes.items()}, units)
        stats = {u: rl.collectives_from_comm_counts(r)
                 for u, (_, r) in probes.items()}
        kinds = set(stats[1].op_bytes) | set(stats[2].op_bytes)
        coll = rl.CollectiveStats(
            op_bytes={k: extrapolate({u: st.op_bytes.get(k, 0.0)
                                      for u, st in stats.items()}, units)
                      for k in sorted(kinds)},
            moved_bytes=extrapolate({u: st.moved_bytes
                                     for u, st in stats.items()}, units),
            n_ops=int(extrapolate({u: st.n_ops for u, st in stats.items()},
                                  units)))
        floor = memory_floor(b, shape.kind)
        mf = rl.model_flops_for(cfg, shape, rl.active_params(cfg))
        roof = rl.compute_roofline(flops, floor, coll, n_dev, mf,
                                   link_bw=rl.CROSS_NODE_BYTES_PER_S)
        rec.update(
            bytes=b, card_bytes=card_bytes, card=card,
            fits=b["state"] <= card_bytes, flops=flops,
            probe_flops={str(u): f for u, (f, _) in probes.items()},
            collectives=coll.to_json(),
            probe_collectives={str(u): st.to_json()
                               for u, st in stats.items()},
            depth_units=units, memory_floor_bytes=floor,
            roofline=roof.to_json())
    except Exception:
        rec["status"] = "error"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    _write(rec, out_dir)
    return rec


def _log(rec: dict) -> None:
    name = " ".join(filter(None, (rec["arch"], rec["shape"],
                                  rec.get("mesh"))))
    msg = rec["status"]
    if rec["status"] == "ok":
        r = rec["roofline"]
        msg += (f" fits={rec['fits']}"
                f" state={rec['bytes']['state'] / 1e9:.2f}GB"
                f" bottleneck={r['bottleneck']}"
                f" terms=({r['compute_s']:.2e},"
                f"{r['memory_s']:.2e},{r['collective_s']:.2e})s"
                f" collective={r['collective_bytes'] / 1e9:.3f}GB"
                f" useful={r['useful_flops_ratio']:.2f}")
    elif rec["status"] == "skipped":
        msg += f" ({rec['reason']})"
    else:
        msg += " " + rec["traceback"].strip().splitlines()[-1]
    print(f"[dryrun] {name}: {msg}", flush=True)


def _cell(path: str, skip_done: bool, run) -> dict:
    """The record at ``path`` when ``skip_done`` and it is ``ok`` or
    ``skipped``, else ``run()``'s; logged either way."""
    if skip_done and os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
        if old.get("status") in ("ok", "skipped"):
            name = os.path.basename(path)[:-len(".json")]
            print(f"[dryrun] {name}: cached", flush=True)
            return old
    rec = run()
    _log(rec)
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default=None,
                    choices=["single", "multi", "both"],
                    help="the production mesh(es) instead of one card")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args(argv)

    archs = sorted(REGISTRY) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    recs = []
    if args.mesh is None:
        for arch in archs:
            for shape in shapes:
                recs.append(_cell(
                    _path(args.out, arch, shape), args.skip_done,
                    lambda: run_cell(arch, shape, args.out)))
        return recs
    import torch.distributed as dist

    for multi in {"single": [False], "multi": [True],
                  "both": [False, True]}[args.mesh]:
        shape_, _ = mesh_lib.PRODUCTION[multi]
        fake_world(math.prod(shape_))
        try:
            mesh = mesh_lib.make_production_mesh(multi_pod=multi,
                                                 device_type="cpu")
            for arch in archs:
                for shape in shapes:
                    recs.append(_cell(
                        _path(args.out, arch, shape, MESH_NAMES[multi]),
                        args.skip_done, lambda: run_mesh_cell(
                            arch, shape, multi, mesh, args.out)))
        finally:
            dist.destroy_process_group()
    return recs


if __name__ == "__main__":
    main()
