"""Fault tolerance for the training loop.

The PyTorch port's counterpart of the JAX package's
``train/fault_tolerance.py``:
  * ``Heartbeat``: a per-step liveness file; a monitor declares the worker
    dead when it goes stale and restarts it from the last checkpoint.
  * ``StragglerMonitor``: flags steps slower than k x the EWMA.
  * ``resume_or_init``: restores the latest durable state (optionally onto
    another device or mesh, the elastic case) or builds a fresh one.
  * ``DataSkipper``: deterministic batch skipping, so a restarted run
    consumes exactly the batches the failed run did not finish; the data
    streams draw every batch from it.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Optional

from . import checkpoint as ckpt_lib


class Heartbeat:
    def __init__(self, path: str, stale_after_s: float = 300.0):
        self.path = path
        self.stale_after_s = stale_after_s
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, step: int, extra: Optional[dict] = None):
        rec = {"step": step, "t": time.time(), **(extra or {})}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self.path)

    def is_stale(self) -> bool:
        try:
            with open(self.path) as f:
                rec = json.load(f)
        except FileNotFoundError:
            return True
        return (time.time() - rec["t"]) > self.stale_after_s


class StragglerMonitor:
    """EWMA of step durations; ``record`` returns True when the last step
    is a straggler (> factor x EWMA), which does not enter the EWMA."""

    def __init__(self, factor: float = 3.0, alpha: float = 0.1):
        self.factor = factor
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.n_stragglers = 0

    def record(self, duration_s: float) -> bool:
        if self.ewma is None:
            self.ewma = duration_s
            return False
        is_straggler = duration_s > self.factor * self.ewma
        if is_straggler:
            self.n_stragglers += 1
        else:
            self.ewma = (1 - self.alpha) * self.ewma \
                + self.alpha * duration_s
        return is_straggler


class DataSkipper:
    """Deterministic seed-per-step batching: after restore at step k, the
    pipeline regenerates batch k+1 exactly, so no data is skipped or
    duplicated across restarts."""

    def __init__(self, base_seed: int):
        self.base_seed = base_seed

    def seed_for_step(self, step: int) -> int:
        return (self.base_seed * 1_000_003 + step) % (2**31 - 1)


def resume_or_init(ckpt_dir: str, init_fn: Callable[[], Any],
                   target_shape: Any = None, device=None,
                   shardings: Any = None) -> tuple:
    """(state, start_step). Restores the latest checkpoint under
    ``ckpt_dir`` into ``target_shape`` (default a fresh ``init_fn()``),
    its leaves on ``device`` (default each target leaf's own) or resharded
    onto ``shardings`` (the elastic path: another mesh), else returns
    ``init_fn()`` and 0."""
    step = ckpt_lib.latest_step(ckpt_dir)
    if step is None:
        return init_fn(), 0
    target = target_shape if target_shape is not None else init_fn()
    return ckpt_lib.restore(ckpt_dir, target, step=step, device=device,
                            shardings=shardings), step
