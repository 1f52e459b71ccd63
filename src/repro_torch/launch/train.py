"""Training launcher.

``python -m repro_torch.launch.train --arch <id> [--objective lm|cox] ...``

The PyTorch port's counterpart of the JAX package's ``launch/train.py``:
config registry -> model -> TrainState -> train step -> deterministic
pipeline -> heartbeat/straggler monitor -> async checkpointing with
resume, on one device (``--device``, default ``cuda``). With
``--production-mesh`` every rank of a world of 256 runs it: the model's
parameters and moments become DTensors on the 16 x 16 (data, model) mesh
by ``launch/sharding.py``'s FSDP/TP rules, each step's batch is sharded
over ``data``, and the loop runs under ``mesh_context`` for the model's
activation anchors; on a smaller world the flag fails, naming the world
it needs.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import device as _device
from ..configs import REGISTRY, TrainConfig, get_config, reduced_config
from ..data.pipeline import SurvivalTextStream, TokenTaskStream
from ..models import build_model
from ..survival.head import init_cox_head
from ..train import checkpoint as ckpt_lib
from ..train import fault_tolerance as ft
from ..train.optimizer import init_opt_state
from ..train.trainer import TrainState, make_train_step
from .mesh import make_production_mesh, mesh_context
from .sharding import shard_model


def build_state(model, objective: str, gen: torch.Generator) -> TrainState:
    """Weights drawn from ``gen``; for ``cox`` a head from a generator
    seeded 7, as the reference's ``PRNGKey(7)``."""
    model.reset_parameters(gen)
    if objective == "cox":
        model.cox_head = init_cox_head(
            torch.Generator(model.device).manual_seed(7), model.cfg.d_model,
            model.device)
    return TrainState(model=model, opt=init_opt_state(model))


def main(argv=None, on_step: Optional[Callable[[int, dict], None]] = None):
    """Returns ``(state, losses)``; ``on_step(step, metrics)`` fires after
    every step, once its loss has been read on the host."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(REGISTRY))
    ap.add_argument("--objective", default="lm", choices=["lm", "cox"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--scale", default="",
                    help="comma k=v ModelConfig overrides, e.g. "
                         "n_layers=8,d_model=512")
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (requires 256 ranks)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    mesh = None
    if args.production_mesh:
        try:
            mesh = make_production_mesh(device_type=dev.type)
        except ValueError as e:
            ap.error(f"--production-mesh: {e}")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if args.scale:
        kw = {}
        for kv in args.scale.split(","):
            k, v = kv.split("=")
            kw[k] = type(getattr(cfg, k))(v)
        cfg = cfg.scaled(**kw)
    cfg = cfg.scaled(vocab_size=min(cfg.vocab_size, 4096))
    model = build_model(cfg, device=dev)
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=20,
                       total_steps=args.steps, microbatch=args.microbatch)

    stream_cls = TokenTaskStream if args.objective == "lm" \
        else SurvivalTextStream
    stream = stream_cls(cfg.vocab_size, args.seq, args.batch, seed=args.seed)

    step_fn = make_train_step(model, tcfg, args.objective)
    hb = ft.Heartbeat(os.path.join(
        args.ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch"),
        "heartbeat.json"))
    mon = ft.StragglerMonitor()
    checkpointer = ckpt_lib.AsyncCheckpointer(args.ckpt_dir) \
        if args.ckpt_dir else None

    def init():
        state = build_state(model, args.objective,
                            torch.Generator(dev).manual_seed(args.seed))
        if mesh is not None:
            shard_model(state.model, mesh, "train")
            state.opt = init_opt_state(state.model)
        return state

    with mesh_context(mesh):
        if args.ckpt_dir:
            state, start = ft.resume_or_init(args.ckpt_dir, init)
            if start:
                print(f"[train] resumed from step {start}")
        else:
            state, start = init(), 0

        losses = []
        for step in range(start, args.steps):
            t0 = time.time()
            state, metrics = step_fn(state, stream.batch_for_step(step))
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.time() - t0
            straggler = mon.record(dt)
            hb.beat(step, {"loss": loss})
            if step % args.log_every == 0 or straggler:
                tag = " STRAGGLER" if straggler else ""
                print(f"[train] step {step} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt*1e3:.0f}ms{tag}", flush=True)
            if on_step is not None:
                on_step(step, metrics)
            if checkpointer and (step + 1) % args.ckpt_every == 0:
                checkpointer.save(step + 1, state)
        if checkpointer:
            checkpointer.save(args.steps, state)
            checkpointer.wait()
    print(f"[train] done: first-10 mean {np.mean(losses[:10]):.4f} "
          f"last-10 mean {np.mean(losses[-10:]):.4f}")
    return state, losses


if __name__ == "__main__":
    main()
