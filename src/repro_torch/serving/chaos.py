"""Deterministic fault injection for the serving stack.

The PyTorch counterpart of the JAX package's ``serving/chaos.py``. The
seeded fault stream is the reference's own (numpy's ``default_rng`` drawn
in the same order), so one seed fails the same calls in both packages.

Every failure mode the robustness layer claims to survive gets a seeded,
reproducible injector here, so tests and ``chip_smoke.py``'s serving
phase can *prove* graceful degradation instead of asserting it:

``ChaosEngine``
    A transparent proxy around a ``ScoringEngine`` that injects, per
    ``score()`` call: raised exceptions (``EngineFault``) and latency
    spikes (``time.sleep``). Faults are driven either by an explicit
    schedule (``fail_next(n)`` / ``spike_next(n, dur)`` — exact, for
    retry/backoff tests) or by a seeded RNG (``error_rate`` /
    ``spike_rate`` — statistically reproducible for soak runs). All
    other attributes delegate to the wrapped engine, so a ``RiskService``
    or ``ModelRegistry`` can't tell the difference.

``corrupt_artifact``
    Deterministically damages one ``.npy`` leaf of a saved
    ``SurvivalModel`` (truncate, or flip a seeded byte) so loads must
    fail with ``ArtifactCorrupt`` — the checksum-verification fixture.

``flood``
    Queue pressure: N submitter threads push requests as fast as the
    service admits them, returning per-outcome counts (admitted / shed
    at the queue). Drives the shed-low-first admission policy tests.

Nothing here is imported by production paths; it lives in ``serving/``
because the injectors are part of the subsystem's contract — every
release of the robustness layer must keep passing under them.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional

import numpy as np

from .service import Priority, QueueFull


class EngineFault(RuntimeError):
    """An injected (synthetic, transient-looking) engine failure."""


class ChaosEngine:
    """Fault-injecting proxy: quacks like the wrapped ScoringEngine."""

    def __init__(self, engine, *, seed: int = 0, error_rate: float = 0.0,
                 spike_rate: float = 0.0, spike_s: float = 0.05):
        self._engine = engine
        self._rng = np.random.default_rng(seed)
        self.error_rate = float(error_rate)
        self.spike_rate = float(spike_rate)
        self.spike_s = float(spike_s)
        self._fail_queue = 0           # scheduled exact failures
        self._spike_queue = 0          # scheduled exact spikes
        self._spike_queue_s = 0.0
        self._lock = threading.Lock()
        self.calls = 0
        self.faults_injected = 0
        self.spikes_injected = 0

    # -- scheduling (exact, for deterministic tests) -----------------------

    def fail_next(self, n: int = 1) -> None:
        """The next ``n`` score() calls raise ``EngineFault``."""
        with self._lock:
            self._fail_queue += int(n)

    def spike_next(self, n: int = 1, dur_s: Optional[float] = None) -> None:
        """The next ``n`` score() calls sleep ``dur_s`` before scoring."""
        with self._lock:
            self._spike_queue += int(n)
            self._spike_queue_s = float(dur_s if dur_s is not None
                                        else self.spike_s)

    # -- the injected call site --------------------------------------------

    def score(self, x, strata=None, with_curves: bool = False):
        with self._lock:
            self.calls += 1
            fail = self._fail_queue > 0
            if fail:
                self._fail_queue -= 1
            spike = self._spike_queue > 0
            spike_s = self._spike_queue_s
            if spike:
                self._spike_queue -= 1
            if not fail and self.error_rate > 0:
                fail = bool(self._rng.random() < self.error_rate)
            if not spike and self.spike_rate > 0:
                spike = bool(self._rng.random() < self.spike_rate)
                spike_s = self.spike_s
        if spike:
            with self._lock:
                self.spikes_injected += 1
            time.sleep(spike_s)
        if fail:
            with self._lock:
                self.faults_injected += 1
            raise EngineFault(
                f"injected engine failure (call {self.calls})")
        return self._engine.score(x, strata, with_curves=with_curves)

    def __getattr__(self, name):
        # everything else (cache_info, prewarm, feature_dim, model, ...)
        # is the wrapped engine's business
        return getattr(self._engine, name)


def corrupt_artifact(path: str, leaf: str = "beta",
                     mode: str = "truncate", seed: int = 0) -> str:
    """Deterministically damage one leaf of a saved artifact.

    ``mode="truncate"`` drops the trailing half of the ``.npy`` file (a
    crashed copy); ``mode="flip"`` XOR-flips one seeded byte past the npy
    header (silent bit rot). Returns the damaged leaf path. Loading the
    artifact afterwards must raise ``ArtifactCorrupt``.
    """
    leaf_path = os.path.join(path, f"{leaf}.npy")
    size = os.path.getsize(leaf_path)
    if mode == "truncate":
        with open(leaf_path, "r+b") as f:
            f.truncate(max(size // 2, 1))
    elif mode == "flip":
        # stay past the ~128-byte npy header so shape/dtype still parse:
        # the *values* are wrong, which only the checksum can catch
        off = 128 + int(np.random.default_rng(seed).integers(
            0, max(size - 129, 1)))
        with open(leaf_path, "r+b") as f:
            f.seek(min(off, size - 1))
            b = f.read(1)
            f.seek(min(off, size - 1))
            f.write(bytes([b[0] ^ 0xFF]))
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return leaf_path


def flood(service, n_per_thread: int, *, n_threads: int = 4,
          priority: Priority = Priority.LOW, feature_dim: int = 8,
          deadline_s: Optional[float] = None, seed: int = 0) -> dict:
    """Queue pressure: hammer ``submit()`` from ``n_threads`` concurrent
    producers. Returns ``{"rids": [...], "admitted": int, "rejected":
    int}`` — every request is accounted for (admitted or shed at the
    queue), which the pressure tests reconcile against the service's own
    counters."""
    rids_by_thread = [[] for _ in range(n_threads)]
    rejected = [0] * n_threads

    def produce(slot):
        rng = np.random.default_rng(seed + slot)
        for _ in range(n_per_thread):
            feats = rng.standard_normal(feature_dim).astype(np.float32)
            try:
                rids_by_thread[slot].append(
                    service.submit(feats, priority=priority,
                                   deadline_s=deadline_s))
            except QueueFull:
                rejected[slot] += 1

    threads = [threading.Thread(target=produce, args=(s,))
               for s in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rids = [rid for slot in rids_by_thread for rid in slot]
    return {"rids": rids, "admitted": len(rids),
            "rejected": int(sum(rejected))}
