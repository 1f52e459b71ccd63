"""Cells at sizes a CPU test run holds: each configuration and traffic
mix shrunk in its sizes alone, the limits kept. The tests drive whole
runs of these on the CPU (``run.execute``) with the program's plain
paths."""
from __future__ import annotations

import importlib.util
import sys

from perfbench import harness

CONFIGS = {
    "appc-n262k-p1000": {"n": 600, "p": 12},
    "mamba2-130m": {"n_layer": 2, "d_model": 64, "d_state": 16,
                    "headdim": 16, "vocab_size": 300},
}
TRAFFIC = {
    "beam-k5": {"k": 3, "finetune_sweeps": 10},
    "seq512-b128": {"batch": 4, "seq": 32, "checked": 2},
}


def cell(name: str, seed: int = 2 ** 31 + 17) -> harness.Cell:
    c = harness.cell(name, seed, device="cpu")
    c.config.update(CONFIGS[c.workload["config"]])
    c.traffic.update(TRAFFIC[c.workload["traffic"]])
    return c


def run_module():
    """``perfbench/run.py`` as a module (it is a script, not a package
    member)."""
    path = harness.HERE / "run.py"
    spec = importlib.util.spec_from_file_location("perfbench_run", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["perfbench_run"] = mod
    spec.loader.exec_module(mod)
    return mod

