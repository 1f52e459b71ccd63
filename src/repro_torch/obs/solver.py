"""Solver convergence telemetry: the paper's monotone-descent guarantee,
monitored.

The PyTorch counterpart of the JAX package's ``obs/solver.py``. Thread a
``TelemetryCallback`` through a fit (``solvers.fit_stream``) and every
outer iteration records (objective, gradient norm, step norm, active-set
size) on the host, checks monotonicity against the neighbouring
iterations, and counts any increase beyond ``tol`` in the
``solver_monotonicity_violations_total`` metric (and emits a
``solver.iter`` event when the JSONL sink is on).

PyTorch runs eagerly, so ``emit_iter`` is a plain host call where the
reference stages a ``jax.debug.callback``: it reads its five values
(``.item()``, one wait on the device each) only when a callback is given,
and costs nothing without one. Records still carry their iteration index
and each adjacent pair is checked once, whatever order they arrive in.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from . import events, metrics


class TelemetryCallback:
    """Host-side per-iteration solver recorder."""

    def __init__(self, solver: str = "solver", tol: float = 1e-6,
                 registry: Optional[metrics.Registry] = None):
        self.solver = solver
        self.tol = float(tol)
        reg = registry if registry is not None else metrics.REGISTRY
        self._iters = reg.counter(
            "solver_iterations_total",
            "outer solver iterations recorded", ("solver",))
        self._violations = reg.counter(
            "solver_monotonicity_violations_total",
            "objective increases beyond tol between consecutive iterations",
            ("solver",))
        self._lock = threading.Lock()
        self._records: Dict[int, dict] = {}

    def _cb(self, it, objective, grad_norm, step_norm, active_set) -> None:
        rec = {"iter": int(it), "objective": float(objective),
               "grad_norm": float(grad_norm),
               "step_norm": float(step_norm),
               "active_set": int(active_set)}
        new_violations = 0
        with self._lock:
            self._records[rec["iter"]] = rec
            # adjacent pairs (it-1, it) and (it, it+1): each pair fires
            # exactly once, when the later-arriving member lands
            for lo in (rec["iter"] - 1, rec["iter"]):
                a = self._records.get(lo)
                b = self._records.get(lo + 1)
                if a is None or b is None or (a is not rec and b is not rec):
                    continue
                if b["objective"] > a["objective"] + self.tol:
                    new_violations += 1
        self._iters.inc(solver=self.solver)
        if new_violations:
            self._violations.inc(new_violations, solver=self.solver)
        events.emit("solver.iter", solver=self.solver, **rec)

    def record_event(self, kind: str, **fields) -> None:
        events.emit(kind, solver=self.solver, **fields)

    @property
    def records(self) -> List[dict]:
        with self._lock:
            return [self._records[i] for i in sorted(self._records)]

    @property
    def objectives(self) -> np.ndarray:
        return np.asarray([r["objective"] for r in self.records])

    @property
    def violations(self) -> int:
        return int(self._violations.value(solver=self.solver))

    @property
    def iterations(self) -> int:
        with self._lock:
            return len(self._records)

    def reset(self) -> None:
        """Drop recorded iterations (counters are cumulative and stay)."""
        with self._lock:
            self._records.clear()


def _value(v):
    return v.item() if hasattr(v, "item") else v


def emit_iter(telemetry: Optional[TelemetryCallback], it, objective,
              grad_norm, step_norm, active_set) -> None:
    """Record one outer iteration; a ``None`` telemetry is free.

    The values may be 0-d tensors (on any device) or Python numbers."""
    if telemetry is None:
        return
    telemetry._cb(*(_value(v) for v in (it, objective, grad_norm, step_norm,
                                        active_set)))
