"""Continuous micro-batching risk API over a ScoringEngine.

The PyTorch counterpart of the JAX package's ``serving/service.py``, the
same host logic over the port's engine: requests land in thread-safe
per-priority queues; each ``step()`` drains up to ``max_batch`` of them,
stacks their float32 feature rows once, hands the batch to the engine
(which pads it to its power-of-two bucket, moves it to the device in one
transfer and runs the curve kernel), and stamps per-request latency.
``start()`` runs the same loop on a background thread (the "continuous"
mode: whatever has queued since the last step forms the next micro-batch
— the dynamic-batch policy of a language-model serving loop, minus the
decode recurrence).

Admission control & overload behavior
-------------------------------------
Two priority classes (``Priority.HIGH`` / ``Priority.LOW``, default LOW)
with strict-priority dequeue and a *shed-low-first* policy: when the
bounded queue (``max_queue``) is full, a HIGH submit evicts the newest
queued LOW request (the one with the least queue time invested) — the
victim's waiter is woken with an ``error="shed"`` response, never
silently lost — while a same-or-lower-priority submit raises
``QueueFull``. Per-request deadlines (``submit(..., deadline_s=...)``)
are enforced *server-side*: an expired request is dropped at batch-form
time with an ``error="deadline_exceeded"`` response instead of wasting a
device dispatch on an answer nobody will read. Together these keep HIGH
p99 bounded past saturation.

Crash safety & health
---------------------
A scoring exception never kills the drain thread: the dispatch is
retried with bounded exponential backoff (``retries`` / ``retry_backoff_s``,
for transient engine faults), and if all attempts fail every request in
the batch gets an ``error=...`` response. The service exposes a readiness
surface — ``health()`` is ``SERVING`` (healthy), ``DEGRADED`` (a recent
dispatch failed or is being retried), or ``DOWN`` (``down_after``
consecutive batches failed after retries) — mirrored into the
``service_health_state`` one-hot gauge; any fully successful batch
returns it to ``SERVING``.

Results lifecycle
-----------------
``wait()`` blocks on a ``threading.Condition`` signaled by ``step()``
(no busy-poll). A ``wait()`` that times out raises ``ScoreTimeout`` and
*abandons* the request: if still queued it is dropped at batch-form
time, and an already-stored response is evicted, so ``_results`` never
accumulates responses nobody will collect. A TTL sweep
(``result_ttl_s``) additionally evicts responses that were never waited
on, keeping a long-running service bounded.

Hot swap
--------
``set_engine()`` atomically replaces the live engine between batches
(the in-flight batch finishes on the engine it started with); it is the
slot ``serving/registry.py`` swaps freshly warmed models into, with zero
dropped requests.

Telemetry (``repro_torch.obs``): every batch is one trace — a ``service.step``
root span with ``service.batch_form`` / ``service.dispatch`` /
``service.respond`` children plus one retroactive ``service.request``
span per request. Always-on metrics: queue-depth gauge, health state
gauge, batch-size and latency histograms, served / rejected / shed /
expired / timeout / retry / engine-failure counters.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ..obs import events as obs_events
from ..obs import metrics as obs_metrics
from ..obs import trace
from .engine import ScoringEngine


class Priority(enum.IntEnum):
    """Two admission classes: HIGH is dequeued first and may evict queued
    LOW work at a full queue (shed-low-first); LOW is best-effort."""

    HIGH = 0
    LOW = 1


HEALTH_STATES = ("SERVING", "DEGRADED", "DOWN")


class ScoreTimeout(TimeoutError):
    """``wait()`` deadline passed before the request was scored. The
    request is abandoned: a late or queued response is evicted."""

    def __init__(self, rid: int, timeout: float):
        super().__init__(f"request {rid} not scored within {timeout}s")
        self.rid = rid
        self.timeout = timeout


class QueueFull(RuntimeError):
    """``submit()`` shed the request: the bounded queue is at capacity
    and the request's priority class cannot evict anything."""

    def __init__(self, max_queue: int):
        super().__init__(f"request shed: queue at capacity ({max_queue})")
        self.max_queue = max_queue


@dataclasses.dataclass
class ScoreRequest:
    rid: int
    features: np.ndarray                 # (p,) or pre-gathered (k,)
    stratum: int = 0
    t_submit: float = 0.0
    priority: Priority = Priority.LOW
    deadline: Optional[float] = None     # absolute perf_counter time


@dataclasses.dataclass
class ScoreResponse:
    rid: int
    risk: float
    median: float
    curve: Optional[np.ndarray]
    latency_s: float
    trace_id: Optional[str] = None       # the batch's trace, when tracing
    error: Optional[str] = None          # terminal failure, when not scored

    @property
    def ok(self) -> bool:
        return self.error is None

    @classmethod
    def failure(cls, rid: int, error: str,
                latency_s: float = 0.0) -> "ScoreResponse":
        return cls(rid=rid, risk=float("nan"), median=float("nan"),
                   curve=None, latency_s=latency_s, error=error)


class RiskService:
    """Priority queues + micro-batch drain loop with admission control,
    crash-safe dispatch, and latency instrumentation."""

    def __init__(self, engine: ScoringEngine, *, max_batch: int = 64,
                 return_curves: bool = False, stats_window: int = 65536,
                 max_queue: Optional[int] = None,
                 retries: int = 2, retry_backoff_s: float = 0.05,
                 max_backoff_s: float = 1.0, down_after: int = 3,
                 result_ttl_s: float = 60.0,
                 registry: Optional[obs_metrics.Registry] = None):
        self.engine = engine
        self.max_batch = max_batch
        self.return_curves = return_curves
        self.max_queue = max_queue
        self.retries = int(retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.down_after = int(down_after)
        self.result_ttl_s = float(result_ttl_s)
        # one mutex guards queues, results, counters, health, and the
        # engine slot; two conditions on it signal new work (the drain
        # loop) and posted results (wait()ers) — no busy-polling anywhere
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._done = threading.Condition(self._lock)
        self._queues: Dict[Priority, Deque[ScoreRequest]] = {
            Priority.HIGH: collections.deque(),
            Priority.LOW: collections.deque()}
        self._results: Dict[int, Tuple[float, ScoreResponse]] = {}
        self._abandoned: set = set()
        self._rid = 0
        self._health = "SERVING"
        self._consec_failures = 0
        self.engine_swaps = 0
        self._last_sweep = time.perf_counter()
        # bounded windows: a long-running continuous service must not grow
        # its instrumentation (or delivered results) without bound
        self._batch_sizes: Deque[int] = collections.deque(
            maxlen=stats_window)
        self._latencies: Deque[float] = collections.deque(
            maxlen=stats_window)
        self._n_served = 0
        self._n_rejected = 0
        self._n_timeouts = 0
        self._n_shed = 0
        self._n_expired = 0
        self._n_errors = 0
        self._n_retries = 0
        self._n_engine_failures = 0
        self._n_evicted = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        reg = registry if registry is not None else obs_metrics.REGISTRY
        self._m_served = reg.counter(
            "service_requests_total", "requests scored")
        self._m_rejected = reg.counter(
            "service_rejected_total", "requests shed at a full queue")
        self._m_timeouts = reg.counter(
            "service_timeouts_total", "wait() deadlines missed")
        self._m_shed = reg.counter(
            "service_shed_total", "queued LOW requests evicted by HIGH")
        self._m_expired = reg.counter(
            "service_deadline_expired_total",
            "requests dropped at batch-form time past their deadline")
        self._m_errors = reg.counter(
            "service_error_responses_total",
            "requests answered with an error after dispatch failure")
        self._m_retries = reg.counter(
            "service_dispatch_retries_total",
            "engine dispatch retries after transient failures")
        self._m_engine_failures = reg.counter(
            "service_engine_failures_total",
            "batches that failed after exhausting retries")
        self._m_evicted = reg.counter(
            "service_results_evicted_total",
            "responses evicted uncollected (timeout abandon or TTL)")
        self._m_swaps = reg.counter(
            "service_engine_swaps_total", "live engine hot-swaps")
        self._m_health = reg.gauge(
            "service_health_state", "readiness one-hot (SERVING/DEGRADED/"
            "DOWN)", ("state",))
        self._m_health.set_state(self._health, HEALTH_STATES)
        self._m_depth = reg.gauge(
            "service_queue_depth", "requests waiting in the queue")
        # callback gauge: depth is read at scrape/snapshot time, the
        # submit/step hot paths never touch it
        self._m_depth.set_fn(self._depth)
        self._m_batch = reg.histogram(
            "service_batch_size", "micro-batch sizes",
            buckets=obs_metrics.POW2_BUCKETS)
        self._m_latency = reg.histogram(
            "service_latency_seconds", "submit -> response latency")
        self._m_queue_wait = reg.histogram(
            "service_queue_wait_seconds", "submit -> batch-form wait")

    # -- request side ------------------------------------------------------

    def _depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def submit(self, features: np.ndarray, stratum: int = 0, *,
               priority: Priority = Priority.LOW,
               deadline_s: Optional[float] = None) -> int:
        """Enqueue one request; returns its rid.

        ``deadline_s`` is a server-side budget: past it the request is
        dropped at batch-form time with an ``error="deadline_exceeded"``
        response. At a full queue a HIGH submit evicts the newest queued
        LOW request (its waiter gets an ``error="shed"`` response);
        otherwise ``QueueFull`` is raised.
        """
        priority = Priority(priority)
        now = time.perf_counter()
        feats = np.asarray(features, np.float32)
        shed_victim: Optional[ScoreRequest] = None
        with self._lock:
            if self.max_queue and self._depth() >= self.max_queue:
                if (priority == Priority.HIGH
                        and self._queues[Priority.LOW]):
                    # shed-low-first: evict the newest LOW arrival (least
                    # queue time invested) to admit the HIGH request
                    shed_victim = self._queues[Priority.LOW].pop()
                else:
                    self._n_rejected += 1
                    self._m_rejected.inc()
                    raise QueueFull(self.max_queue)
            rid = self._rid
            self._rid += 1
            if self._t_first is None:
                self._t_first = now
            req = ScoreRequest(
                rid=rid, features=feats, stratum=stratum, t_submit=now,
                priority=priority,
                deadline=None if deadline_s is None else now + deadline_s)
            self._queues[priority].append(req)
            if shed_victim is not None:
                self._n_shed += 1
                self._post_locked(shed_victim.rid, ScoreResponse.failure(
                    shed_victim.rid, "shed",
                    latency_s=now - shed_victim.t_submit))
            self._work.notify()
        if shed_victim is not None:
            self._m_shed.inc()
        return rid

    def result(self, rid: int) -> Optional[ScoreResponse]:
        """Retrieve (and hand over) a scored response. The response is
        popped so delivered results don't accumulate in a long-running
        service; a second call for the same rid returns None."""
        with self._lock:
            entry = self._results.pop(rid, None)
            return entry[1] if entry is not None else None

    def wait(self, rid: int, timeout: float = 30.0) -> ScoreResponse:
        """Block until rid's response is posted (condition-signaled; no
        spin). On timeout, raises ``ScoreTimeout`` and abandons the
        request — a queued copy is dropped at batch-form time and a late
        response is evicted rather than stored forever."""
        deadline = time.perf_counter() + timeout
        with self._done:
            while True:
                entry = self._results.pop(rid, None)
                if entry is not None:
                    return entry[1]
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    self._n_timeouts += 1
                    self._abandoned.add(rid)
                    break
                self._done.wait(remaining)
        self._m_timeouts.inc()
        raise ScoreTimeout(rid, timeout)

    # -- serving side ------------------------------------------------------

    def _post_locked(self, rid: int, resp: ScoreResponse) -> None:
        """Store (or drop, if abandoned) one terminal response and wake
        waiters. Caller holds ``self._lock``."""
        if rid in self._abandoned:
            self._abandoned.discard(rid)
            self._n_evicted += 1
            self._m_evicted.inc()
        else:
            self._results[rid] = (time.perf_counter(), resp)
        if resp.error is not None:
            self._n_errors += 1
            self._m_errors.inc()
        self._done.notify_all()

    def _sweep_locked(self, now: float) -> None:
        """TTL-evict responses nobody collected. Caller holds the lock."""
        if now - self._last_sweep < max(self.result_ttl_s / 4.0, 0.25):
            return
        self._last_sweep = now
        dead = [rid for rid, (t_post, _) in self._results.items()
                if now - t_post > self.result_ttl_s]
        for rid in dead:
            del self._results[rid]
        if dead:
            self._n_evicted += len(dead)
            self._m_evicted.inc(len(dead))

    def _form_batch(self) -> Tuple[List[ScoreRequest], int, int]:
        """Pop up to max_batch requests, HIGH before LOW, dropping
        expired or abandoned ones with terminal outcomes. Returns
        (batch, n_expired, n_abandoned)."""
        reqs: List[ScoreRequest] = []
        n_expired = n_abandoned = 0
        now = time.perf_counter()
        with self._lock:
            for prio in (Priority.HIGH, Priority.LOW):
                q = self._queues[prio]
                while q and len(reqs) < self.max_batch:
                    req = q.popleft()
                    if req.rid in self._abandoned:
                        # waiter gave up: skip the device work entirely
                        self._abandoned.discard(req.rid)
                        self._n_evicted += 1
                        n_abandoned += 1
                        continue
                    if req.deadline is not None and now > req.deadline:
                        self._n_expired += 1
                        n_expired += 1
                        self._post_locked(req.rid, ScoreResponse.failure(
                            req.rid, "deadline_exceeded",
                            latency_s=now - req.t_submit))
                        continue
                    reqs.append(req)
                if len(reqs) >= self.max_batch:
                    break
            self._sweep_locked(now)
        if n_expired:
            self._m_expired.inc(n_expired)
        if n_abandoned:
            self._m_evicted.inc(n_abandoned)
        return reqs, n_expired, n_abandoned

    def _set_health(self, state: str) -> None:
        if state != self._health:
            self._health = state
            obs_events.emit("service.health", state=state,
                            consec_failures=self._consec_failures)
        self._m_health.set_state(state, HEALTH_STATES)

    def _dispatch(self, x: np.ndarray, strata: np.ndarray):
        """One engine call with bounded exponential-backoff retries.
        Returns the engine output or raises the last failure."""
        engine = self.engine        # snapshot: hot-swap safe per batch
        attempt = 0
        while True:
            try:
                out = engine.score(x, strata,
                                   with_curves=self.return_curves)
                if attempt > 0:
                    obs_events.emit("service.retry_recovered",
                                    attempts=attempt + 1)
                return out
            except Exception:
                with self._lock:
                    self._set_health("DEGRADED")
                if attempt >= self.retries:
                    raise
                backoff = min(self.retry_backoff_s * (2.0 ** attempt),
                              self.max_backoff_s)
                attempt += 1
                with self._lock:
                    self._n_retries += 1
                self._m_retries.inc()
                time.sleep(backoff)

    def step(self) -> int:
        """Score one micro-batch (whatever is queued, capped at
        max_batch). Returns the number of requests *scored*; expired,
        abandoned, or failed requests resolve to terminal responses but
        don't count. Never raises on engine failure: the batch turns
        into per-request error responses and a health transition."""
        if not self._depth():    # idle poll: no spans for empty steps
            return 0
        with trace.span("service.step") as step_span:
            with trace.span("service.batch_form"):
                reqs, _, _ = self._form_batch()
                if not reqs:
                    return 0
                t_formed = time.perf_counter()
                x = np.stack([r.features for r in reqs])
                strata = np.asarray([r.stratum for r in reqs], np.int32)
            step_span.set(batch=len(reqs))
            try:
                with trace.span("service.dispatch", batch=len(reqs)):
                    out = self._dispatch(x, strata)
            except Exception as e:
                # crash-safe: the batch resolves to error responses, the
                # drain loop lives on, and readiness degrades instead of
                # the thread dying silently
                err = f"{type(e).__name__}: {e}"
                step_span.set(error=type(e).__name__)
                t_fail = time.perf_counter()
                with self._lock:
                    self._n_engine_failures += 1
                    self._consec_failures += 1
                    self._set_health(
                        "DOWN" if self._consec_failures >= self.down_after
                        else "DEGRADED")
                    for r in reqs:
                        self._post_locked(r.rid, ScoreResponse.failure(
                            r.rid, err, latency_s=t_fail - r.t_submit))
                self._m_engine_failures.inc()
                obs_events.emit("service.batch_failed", batch=len(reqs),
                                error=err)
                return 0
            risks, medians = out[0], out[1]
            curves = out[2] if self.return_curves else None
            with trace.span("service.respond"):
                t_done = time.perf_counter()
                traced = trace.enabled()
                with self._lock:
                    self._consec_failures = 0
                    self._set_health("SERVING")
                    self._batch_sizes.append(len(reqs))
                    self._n_served += len(reqs)
                    self._t_last = t_done
                    for i, r in enumerate(reqs):
                        lat = t_done - r.t_submit
                        self._latencies.append(lat)
                        self._post_locked(r.rid, ScoreResponse(
                            rid=r.rid, risk=float(risks[i]),
                            median=float(medians[i]),
                            curve=None if curves is None else curves[i],
                            latency_s=lat,
                            trace_id=step_span.trace_id))
                self._m_served.inc(len(reqs))
                self._m_batch.observe(len(reqs))
                subs = np.fromiter((r.t_submit for r in reqs),
                                   dtype=float, count=len(reqs))
                self._m_queue_wait.observe_many(t_formed - subs)
                self._m_latency.observe_many(t_done - subs)
                if traced:
                    for r in reqs:
                        trace.emit_span("service.request",
                                        t_done - r.t_submit, rid=r.rid,
                                        queue_wait_s=t_formed - r.t_submit)
            return len(reqs)

    def drain(self) -> int:
        """Serve until the queue is empty; returns requests scored."""
        total = 0
        while True:
            n = self.step()
            if n == 0 and not self._depth():
                return total
            total += n

    def start(self, poll_s: float = 0.05):
        """Continuous mode: drain micro-batches on a background thread.
        The loop sleeps on a condition signaled by ``submit()`` —
        ``poll_s`` only bounds stop/TTL-sweep latency, idle CPU is ~0.
        The loop itself is crash-safe: an unexpected exception (outside
        the per-batch handling in ``step()``) degrades health and
        continues instead of killing the thread."""
        if self._thread is not None:
            return
        self._stop.clear()

        def _loop():
            while not self._stop.is_set():
                try:
                    served = self.step()
                except Exception as e:     # pragma: no cover - last ditch
                    with self._lock:
                        self._set_health("DEGRADED")
                    obs_events.emit("service.loop_error",
                                    error=f"{type(e).__name__}: {e}")
                    time.sleep(min(poll_s, 0.05))
                    continue
                if served == 0:
                    with self._work:
                        if not self._depth() and not self._stop.is_set():
                            self._sweep_locked(time.perf_counter())
                            self._work.wait(poll_s)

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="risk-service-drain")
        self._thread.start()

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        with self._work:
            self._work.notify_all()
        self._thread.join()
        self._thread = None

    @property
    def thread_alive(self) -> bool:
        """True while the background drain thread is running."""
        return self._thread is not None and self._thread.is_alive()

    # -- hot swap ----------------------------------------------------------

    def set_engine(self, engine: ScoringEngine) -> None:
        """Atomically swap the live engine between batches. The in-flight
        batch finishes on the engine it snapshotted; queued requests are
        untouched, so a rollout drops zero requests. Called by
        ``ModelRegistry.swap``."""
        with self._lock:
            self.engine = engine
            self.engine_swaps += 1
        self._m_swaps.inc()
        obs_events.emit("service.engine_swap", swaps=self.engine_swaps)

    # -- instrumentation ---------------------------------------------------

    def health(self) -> str:
        """Readiness: SERVING | DEGRADED | DOWN."""
        with self._lock:
            return self._health

    def stats(self) -> dict:
        """Served-request counters, throughput, health, and windowed
        latency percentiles (over the last ``stats_window`` requests).

        Every key is always present — before the first request completes
        the percentiles are 0.0 and the throughput NaN — so dashboards
        and tests never key-error on a fresh or idle service."""
        with self._lock:
            lats = np.asarray(self._latencies)
            n = self._n_served
            rejected = self._n_rejected
            timeouts = self._n_timeouts
            wall = ((self._t_last - self._t_first)
                    if (self._t_first is not None
                        and self._t_last is not None) else 0.0)
            sizes = list(self._batch_sizes)
            extra = {"shed_count": self._n_shed,
                     "expired_count": self._n_expired,
                     "error_count": self._n_errors,
                     "retry_count": self._n_retries,
                     "engine_failures": self._n_engine_failures,
                     "results_evicted": self._n_evicted,
                     "results_pending": len(self._results),
                     "engine_swaps": self.engine_swaps,
                     "health": self._health}
            depth = self._depth()
        out = {"n_requests": n, "wall_s": wall,
               "reqs_per_s": (n / wall) if wall > 0 else float("nan"),
               "n_batches": len(sizes),
               "mean_batch": float(np.mean(sizes)) if sizes else 0.0,
               "queue_depth": depth,
               "rejected_count": rejected,
               "timeout_count": timeouts,
               "latency_p50_ms": (float(np.percentile(lats, 50) * 1e3)
                                  if len(lats) else 0.0),
               "latency_p99_ms": (float(np.percentile(lats, 99) * 1e3)
                                  if len(lats) else 0.0),
               "engine": self.engine.cache_info()}
        out.update(extra)
        return out
