"""Model registry with background pre-warm and atomic hot-swap.

The PyTorch counterpart of the JAX package's ``serving/registry.py``. By
default each model's engine is the port's ``ScoringEngine`` on the card;
pass ``engine_factory`` to build it elsewhere (the CPU, in tests).

The fleet-management layer over ``RiskService``: where the service owns
*requests*, the registry owns *models*. It keeps a table of named
``SurvivalModel`` artifacts, each wrapped in its own ``ScoringEngine``,
and rolls a freshly trained model into the live serving slot with zero
dropped requests:

    reg = ModelRegistry(service)
    reg.load("champ_v2", "/models/champ_v2")     # verify + build + warm
    reg.swap("champ_v2")                          # atomic, between batches
    reg.unload("champ_v1")                        # drop the old engine

Lifecycle of an entry: ``loading`` (artifact read + checksum verify —
a corrupt artifact fails here with ``ArtifactCorrupt``, never reaching
the live slot) -> ``warming`` (the engine builds and runs each bucket
once, launching its curve kernel, while the old model keeps serving)
-> ``ready`` (swappable) -> ``live`` after ``swap`` -> ``unloaded`` once retired. A failure at
any stage parks the entry at ``failed`` with the error recorded; the
live engine is untouched.

``swap`` bumps a monotone ``generation`` counter (stamped on the entry
it promoted) and calls ``RiskService.set_engine``, which replaces the
engine slot under the service lock *between* micro-batches: the
in-flight batch finishes on the engine it snapshotted, queued requests
score on the new one — the saxml servable-model rollout discipline
(load/warm off-path, serve continuously).

``load(..., block=False)`` warms on a daemon thread for rollouts under
live traffic; ``rollout()`` is the one-call convenience (load -> swap ->
unload previous). Metrics: ``registry_models`` gauge,
``registry_swaps_total`` / ``registry_load_failures_total`` counters,
plus ``registry.*`` lifecycle events on the JSONL sink.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional, Sequence, Union

from ..obs import events as obs_events
from ..obs import metrics as obs_metrics
from .artifacts import ArtifactCorrupt, SurvivalModel
from .engine import ScoringEngine
from .service import RiskService

# entry lifecycle states
LOADING, WARMING, READY, LIVE, FAILED, UNLOADED = (
    "loading", "warming", "ready", "live", "failed", "unloaded")


@dataclasses.dataclass
class ModelEntry:
    """One registered model and its serving state."""

    model_id: str
    state: str = LOADING
    path: Optional[str] = None
    model: Optional[SurvivalModel] = None
    engine: Optional[ScoringEngine] = None
    error: Optional[str] = None
    generation: Optional[int] = None     # generation at which it went live
    compiles: int = 0                    # query builds during warm

    @property
    def ready(self) -> bool:
        return self.state in (READY, LIVE)


class ModelRegistry:
    """Named ``SurvivalModel`` fleet feeding one ``RiskService`` slot."""

    def __init__(self, service: Optional[RiskService] = None, *,
                 engine_factory: Optional[
                     Callable[[SurvivalModel], ScoringEngine]] = None,
                 prewarm_batches: Optional[Sequence[int]] = None,
                 prewarm: bool = True,
                 registry: Optional[obs_metrics.Registry] = None):
        self._service = service
        self._factory = engine_factory or ScoringEngine
        if prewarm_batches is None:
            # every pow-2 bucket the service can hit: a partially-warmed
            # engine stalls live traffic on mid-ladder compiles (a batch
            # of 3 hits bucket 4) — warm the whole ladder by default
            mb = max(service.max_batch if service is not None else 64, 1)
            prewarm_batches = tuple(
                1 << i for i in range((mb - 1).bit_length() + 1))
        self.prewarm_batches = tuple(int(b) for b in prewarm_batches)
        self.prewarm = bool(prewarm)
        self._lock = threading.Lock()
        self._entries: Dict[str, ModelEntry] = {}
        self._threads: Dict[str, threading.Thread] = {}
        self.generation = 0
        self.live_id: Optional[str] = None
        reg = registry if registry is not None else obs_metrics.REGISTRY
        self._m_models = reg.gauge(
            "registry_models", "models registered (any state)")
        self._m_models.set_fn(lambda: len(self._entries))
        self._m_swaps = reg.counter(
            "registry_swaps_total", "live-engine model swaps")
        self._m_failures = reg.counter(
            "registry_load_failures_total",
            "model loads that failed (corrupt artifact, bad build)")

    # -- load / warm -------------------------------------------------------

    def _build(self, entry: ModelEntry,
               source: Union[str, SurvivalModel]) -> None:
        """Artifact read (checksum-verified) -> engine -> warm buckets.
        Any failure parks the entry at FAILED; nothing touches the live
        slot until an explicit ``swap``."""
        try:
            if isinstance(source, SurvivalModel):
                model = source
            else:
                entry.path = str(source)
                model = SurvivalModel.load(entry.path)   # verifies sha256
            engine = self._factory(model)
            with self._lock:
                entry.model = model
                entry.engine = engine
                entry.state = WARMING
            if self.prewarm:
                kinds = ("score_curves" if self._service is not None
                         and self._service.return_curves else "score",)
                entry.compiles = engine.prewarm(
                    self.prewarm_batches, kinds=kinds,
                    strata=model.n_strata > 1)
            with self._lock:
                entry.state = READY
            obs_events.emit("registry.ready", model_id=entry.model_id,
                            compiles=entry.compiles)
        except Exception as e:
            with self._lock:
                entry.state = FAILED
                entry.error = f"{type(e).__name__}: {e}"
            self._m_failures.inc()
            obs_events.emit("registry.load_failed",
                            model_id=entry.model_id, error=entry.error)

    def load(self, model_id: str, source: Union[str, SurvivalModel], *,
             block: bool = True) -> ModelEntry:
        """Register ``model_id`` from an artifact path or an in-memory
        ``SurvivalModel`` and warm its engine. ``block=False`` warms on a
        daemon thread (rollouts under live traffic); poll
        ``entry.state`` or call ``wait_ready``. Re-loading an id replaces
        its entry unless that id is currently live."""
        with self._lock:
            if model_id == self.live_id:
                raise ValueError(
                    f"model {model_id!r} is live; load under a new id "
                    "and swap")
            entry = ModelEntry(model_id=model_id)
            self._entries[model_id] = entry
        obs_events.emit("registry.load", model_id=model_id,
                        source=source if isinstance(source, str) else
                        "<in-memory>")
        if block:
            self._build(entry, source)
            if entry.state == FAILED:
                exc = (ArtifactCorrupt
                       if "ArtifactCorrupt" in (entry.error or "")
                       else RuntimeError)
                raise exc(f"load of {model_id!r} failed: {entry.error}")
        else:
            t = threading.Thread(target=self._build,
                                 args=(entry, source), daemon=True,
                                 name=f"registry-warm-{model_id}")
            self._threads[model_id] = t
            t.start()
        return entry

    def wait_ready(self, model_id: str, timeout: float = 60.0) -> ModelEntry:
        """Join a background load; raises on timeout or failed load."""
        t = self._threads.pop(model_id, None)
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                self._threads[model_id] = t
                raise TimeoutError(
                    f"model {model_id!r} still warming after {timeout}s")
        entry = self.get(model_id)
        if entry.state == FAILED:
            raise RuntimeError(
                f"load of {model_id!r} failed: {entry.error}")
        return entry

    # -- swap / unload -----------------------------------------------------

    def swap(self, model_id: str) -> int:
        """Promote a READY model into the live engine slot. Atomic with
        respect to the serving loop (between micro-batches); zero queued
        or in-flight requests are dropped. Returns the new generation."""
        with self._lock:
            entry = self._entries.get(model_id)
            if entry is None:
                raise KeyError(f"unknown model {model_id!r}")
            if not entry.ready or entry.engine is None:
                raise RuntimeError(
                    f"model {model_id!r} not swappable (state="
                    f"{entry.state}{', ' + entry.error if entry.error else ''})")
            self.generation += 1
            gen = entry.generation = self.generation
            prev_id, self.live_id = self.live_id, model_id
            entry.state = LIVE
            prev = self._entries.get(prev_id) if prev_id else None
            if prev is not None and prev.state == LIVE:
                prev.state = READY
            engine = entry.engine
        if self._service is not None:
            self._service.set_engine(engine)
        self._m_swaps.inc()
        obs_events.emit("registry.swap", model_id=model_id,
                        generation=gen, previous=prev_id)
        return gen

    def unload(self, model_id: str) -> None:
        """Retire a model: drop its engine (built queries, device state)
        and artifact references. The live model cannot be unloaded — swap
        first."""
        with self._lock:
            if model_id == self.live_id:
                raise ValueError(
                    f"model {model_id!r} is live; swap before unloading")
            entry = self._entries.get(model_id)
            if entry is None:
                raise KeyError(f"unknown model {model_id!r}")
            entry.engine = None
            entry.model = None
            entry.state = UNLOADED
        self._threads.pop(model_id, None)
        obs_events.emit("registry.unload", model_id=model_id)

    def rollout(self, model_id: str, source: Union[str, SurvivalModel],
                *, unload_previous: bool = True) -> int:
        """Load + warm + swap in one call; optionally unloads the model
        it replaced. The load/warm happens entirely off the serving path,
        so live traffic only ever sees warmed engines."""
        self.load(model_id, source, block=True)
        prev = self.live_id
        gen = self.swap(model_id)
        if unload_previous and prev is not None and prev != model_id:
            self.unload(prev)
        return gen

    # -- introspection -----------------------------------------------------

    def get(self, model_id: str) -> ModelEntry:
        with self._lock:
            entry = self._entries.get(model_id)
        if entry is None:
            raise KeyError(f"unknown model {model_id!r}")
        return entry

    def engine(self, model_id: Optional[str] = None) -> ScoringEngine:
        """The live engine (default) or a named entry's engine."""
        with self._lock:
            mid = model_id or self.live_id
            entry = self._entries.get(mid) if mid else None
        if entry is None or entry.engine is None:
            raise KeyError(f"no engine for model {mid!r}")
        return entry.engine

    def status(self) -> dict:
        """Readiness surface: live id, generation, per-model states."""
        with self._lock:
            return {
                "live": self.live_id,
                "generation": self.generation,
                "models": {mid: {"state": e.state, "error": e.error,
                                 "generation": e.generation}
                           for mid, e in self._entries.items()},
            }
