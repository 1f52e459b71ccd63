"""SHA-256 digests of the port's plain (unsharded) path, to show that a
change kept its bits.

For every architecture, reduced, in float32 and bfloat16: the logits and
every cache leaf of ``prefill`` and of 3 ``decode_step`` calls, one
``loss_lm`` and its every gradient, and the parameters and moments after
3 AdamW steps (``trainer.make_train_step``, ``lm``) and after 3
microbatched steps (``microbatch=2``). Run it on two trees and compare:

    python3 scripts/plain_path_digest.py --src build/parent/src > a.json
    python3 scripts/plain_path_digest.py --src src > b.json

One JSON object on stdout, {"arch/dtype/what": sha256}. On the CPU
(``--device``, default cpu), ~16 s.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import copy

    import numpy as np
    import torch

    from repro_torch.configs import (REGISTRY, TrainConfig, get_config,
                                     reduced_config)
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import TrainState, make_train_step

    torch.set_num_threads(4)
    dev = torch.device(args.device)

    def digest(tensors) -> str:
        h = hashlib.sha256()
        for t in tensors:
            t = t.detach().cpu().contiguous().reshape(-1)
            h.update(str((tuple(t.shape), t.dtype)).encode())
            h.update(t.view(torch.uint8).numpy().tobytes()
                     if t.numel() else b"")
        return h.hexdigest()

    def inputs(cfg, rng, b, s):
        batch = {"labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)}
        if cfg.family == "encdec":
            batch["src_embeds"] = rng.standard_normal(
                (b, s, cfg.d_model)).astype(np.float32)
        if cfg.frontend in ("audio", "vision") and cfg.family != "encdec":
            batch["embeds"] = rng.standard_normal(
                (b, s, cfg.d_model)).astype(np.float32)
        else:
            batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32)
        return batch

    out = {}
    for arch in sorted(REGISTRY):
        for dtype in ("float32", "bfloat16"):
            cfg = reduced_config(get_config(arch)).scaled(dtype=dtype)
            key = f"{arch}/{dtype}"
            rng = np.random.default_rng(0)
            model = Model(cfg, device=dev,
                          generator=torch.Generator(dev).manual_seed(0))
            batch = inputs(cfg, rng, 4, 12)
            on_dev = {k: torch.as_tensor(v, device=dev)
                      for k, v in batch.items()}
            logits, cache = model.prefill(
                {k: v for k, v in on_dev.items() if k != "labels"},
                max_len=20)
            out[f"{key}/prefill"] = digest([logits, *cache])
            for i in range(3):
                tok = torch.as_tensor(rng.integers(
                    0, cfg.vocab_size, (4, 1)).astype(np.int32), device=dev)
                logits, cache = model.decode_step(cache, tok)
                out[f"{key}/decode{i + 1}"] = digest([logits, *cache])
            loss, _ = model.loss_lm(on_dev)
            params = list(model.parameters())
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            out[f"{key}/loss_lm"] = digest(
                [loss] + [g for g in grads if g is not None])
            for micro in (0, 2):
                m = copy.deepcopy(model)
                state = TrainState(model=m, opt=init_opt_state(m))
                tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2,
                                   total_steps=10, microbatch=micro)
                step = make_train_step(m, tcfg, "lm")
                losses = []
                for i in range(3):
                    state, metrics = step(state, inputs(cfg, rng, 4, 8))
                    losses.append(metrics["loss"])
                out[f"{key}/train{'_micro' if micro else ''}"] = digest(
                    losses + list(state.model.parameters())
                    + list(state.opt.m.values())
                    + list(state.opt.v.values()))
    print(json.dumps(out, sort_keys=True))


if __name__ == "__main__":
    main()
