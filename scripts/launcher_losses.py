#!/usr/bin/env python3
"""Loss trajectories of the train launcher at qwen2.5-3b's published
widths under several learning rates, run lengths and parameter dtypes.

    python3 scripts/launcher_losses.py [--device cuda|cpu] [--scale K=V,...]
                                       [--runs LR:STEPS:DTYPE,...]

Each run is ``repro_torch.launch.train.main`` in-process with
``--objective lm``, batch 8 x seq 64, seed 0 and ``--scale`` (default
``n_layers=12``, as ``chip_smoke.py``'s launcher check) plus the run's
``dtype=``; the launcher warms up over 20 steps and then decays by cosine
to 10 % of the rate at the run's last step. The default runs are the
smoke script's own (1e-3, 20 steps, bfloat16), the same rate over 100
steps, the same 20 steps at 3e-4 and 1e-4, and the float32 twin at 1e-3.

Prints the card's name and power limit (nvidia-smi), then one JSON line:
for each run its rate, steps, dtype, every step's loss, the first-10 and
last-10 means and the median seconds a step after step 5.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

RUNS = "1e-3:20:bfloat16,1e-3:100:bfloat16,3e-4:20:bfloat16," \
       "1e-4:20:bfloat16,1e-3:20:float32"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", default="n_layers=12")
    ap.add_argument("--runs", default=RUNS)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.launch import train as train_cli

    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)
    out = []
    for run in args.runs.split(","):
        lr, steps, dtype = run.split(":")
        stamps = []

        def on_step(step, metrics):
            stamps.append(time.perf_counter())

        state, losses = train_cli.main([
            "--arch", "qwen2.5-3b", "--objective", "lm",
            "--scale", f"{args.scale},dtype={dtype}", "--steps", steps,
            "--lr", lr, "--batch", "8", "--seq", "64",
            "--log-every", "1000", "--device", args.device],
            on_step=on_step)
        dts = np.diff(stamps)
        out.append({
            "lr": float(lr), "steps": int(steps), "dtype": dtype,
            "losses": [float(x) for x in losses],
            "first10": float(np.mean(losses[:10])),
            "last10": float(np.mean(losses[-10:])),
            "s_per_step": float(statistics.median(dts[5:]))
            if len(dts) > 5 else None})
        del state
        if args.device == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"runs": out}))
    return {"runs": out}


if __name__ == "__main__":
    main()
