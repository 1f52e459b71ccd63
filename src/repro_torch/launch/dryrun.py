"""Dry run of every (architecture x shape) cell on the meta device, for
one NVIDIA H100.

    python -m repro_torch.launch.dryrun [--arch a,b] [--shape s,t]
        [--out build/dryrun_torch] [--skip-done]

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

One JSON a cell goes to ``--out`` (``build/dryrun_torch/``);
``analysis/report.py`` renders them.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..analysis import roofline as rl
from ..configs import (REGISTRY, SHAPES, TrainConfig, applicable_shapes,
                       get_config)
from ..models.model import Model
from ..train import optimizer as opt_lib
from ..train.trainer import TrainState, make_train_step

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


def count_flops(cfg, shape, tcfg=None) -> float:
    """FLOPs of one step of ``shape.kind`` for ``cfg``, on meta tensors."""
    model = Model(cfg, device=META)
    batch = model.make_input_specs(shape)
    with FlopCounterMode(display=False) as counter:
        if shape.kind == "train":
            state = TrainState(model=model,
                               opt=opt_lib.init_opt_state(model))
            make_train_step(model, tcfg or TrainConfig())(state, batch)
        elif shape.kind == "prefill":
            model.prefill(batch, max_len=shape.seq_len)
        else:
            model.decode_step(model.init_cache_specs(shape.global_batch,
                                                     shape.seq_len),
                              batch["tokens"])
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


def _path(out_dir: str, arch: str, shape_name: str) -> str:
    return os.path.join(out_dir, f"{arch}_{shape_name}.json")


def _write(rec: dict, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    with open(_path(out_dir, rec["arch"], rec["shape"]), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args(argv)

    archs = sorted(REGISTRY) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    recs = []
    for arch in archs:
        for shape in shapes:
            path = _path(args.out, arch, shape)
            if args.skip_done and os.path.exists(path):
                with open(path) as f:
                    old = json.load(f)
                if old.get("status") in ("ok", "skipped"):
                    print(f"[dryrun] {arch} {shape}: cached", flush=True)
                    recs.append(old)
                    continue
            rec = run_cell(arch, shape, args.out)
            recs.append(rec)
            msg = rec["status"]
            if rec["status"] == "ok":
                r = rec["roofline"]
                msg += (f" fits={rec['fits']}"
                        f" bottleneck={r['bottleneck']}"
                        f" terms=({r['compute_s']:.2e},"
                        f"{r['memory_s']:.2e},{r['collective_s']:.2e})s"
                        f" useful={r['useful_flops_ratio']:.2f}")
            elif rec["status"] == "skipped":
                msg += f" ({rec['reason']})"
            print(f"[dryrun] {arch} {shape}: {msg}", flush=True)
    return recs


if __name__ == "__main__":
    main()
