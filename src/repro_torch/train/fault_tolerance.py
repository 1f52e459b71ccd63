"""Restart-safe data order.

The PyTorch port's counterpart of the JAX package's
``train/fault_tolerance.py``. Only ``DataSkipper`` is ported yet: the data
streams draw every batch from it. The straggler monitor and
``resume_or_init`` wait for the training slice (ROADMAP A8c).
"""
from __future__ import annotations


class DataSkipper:
    """Deterministic seed-per-step batching: after restore at step k, the
    pipeline regenerates batch k+1 exactly, so no data is skipped or
    duplicated across restarts."""

    def __init__(self, base_seed: int):
        self.base_seed = base_seed

    def seed_for_step(self, step: int) -> int:
        return (self.base_seed * 1_000_003 + step) % (2**31 - 1)
