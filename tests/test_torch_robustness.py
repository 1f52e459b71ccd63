"""Port's serving robustness (serving/chaos.py, registry.py, service.py):
the reference's checks of tests/test_robustness.py on the CPU, with the
same timing margins and tolerances (a served risk against the new model's
engine at 1e-6 relative, float32 at one bucket), plus a seeded ChaosEngine
that fails the same calls as the JAX package's under one seed.

Every injected failure — engine exception, latency spike, corrupt
artifact, queue pressure — must yield a graceful outcome (error response,
shed, or health transition) with zero silent request loss and the drain
thread still alive. Plus the registry hot-swap lifecycle, admission-control
edges, and the results-lifecycle bounds (timeout abandon, TTL sweep)."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import ChaosEngine as JChaosEngine  # noqa: E402
from repro.serving import EngineFault as JEngineFault  # noqa: E402
from repro_torch.serving import (ArtifactCorrupt, ChaosEngine,  # noqa: E402
                                 EngineFault, ModelRegistry, Priority,
                                 QueueFull, RiskService, ScoringEngine,
                                 SurvivalModel, corrupt_artifact)
from repro_torch.serving import fit_survival_model  # noqa: E402
from repro_torch.serving.chaos import flood  # noqa: E402
from repro_torch.serving.registry import LIVE, READY, UNLOADED  # noqa: E402


def _problem(n=160, p=8, seed=0, scale=0.4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, p)).astype(np.float32)
    t = rng.uniform(0.1, 2.0, n).astype(np.float32)
    delta = (rng.uniform(size=n) < 0.7).astype(np.float32)
    beta = (rng.standard_normal(p) * scale).astype(np.float32)
    return x, t, delta, beta


def _model(seed=0, scale=0.4, p=8):
    x, t, delta, beta = _problem(seed=seed, scale=scale, p=p)
    return x, fit_survival_model(x, t, delta, beta, device="cpu")


def _engine(model):
    return ScoringEngine(model, device="cpu")


# ---------------------------------------------------------------------------
# Admission control: deadlines, priorities, shed-low-first
# ---------------------------------------------------------------------------

def test_deadline_expired_dropped_at_batch_form():
    x, model = _model()
    svc = RiskService(_engine(model), max_batch=8)
    live = svc.submit(x[0])                       # no deadline
    dead = svc.submit(x[1], deadline_s=0.0)       # already expired
    time.sleep(0.005)
    assert svc.drain() == 1                       # only the live one scored
    assert svc.result(live).ok
    resp = svc.result(dead)
    assert resp is not None and resp.error == "deadline_exceeded"
    st = svc.stats()
    assert st["expired_count"] == 1
    assert st["n_requests"] == 1                  # expired never dispatched


def test_high_priority_dequeued_first():
    x, model = _model()
    eng = _engine(model)
    svc = RiskService(eng, max_batch=2)
    lows = [svc.submit(x[i], priority=Priority.LOW) for i in range(4)]
    high = svc.submit(x[4], priority=Priority.HIGH)
    assert svc.step() == 2
    # the first batch is the HIGH request + the oldest LOW
    assert svc.result(high) is not None
    assert svc.result(lows[0]) is not None
    assert all(svc.result(r) is None for r in lows[1:])
    svc.drain()


def test_shed_low_first_eviction_wakes_low_waiter():
    x, model = _model()
    svc = RiskService(_engine(model), max_batch=8, max_queue=2)
    lo1 = svc.submit(x[0], priority=Priority.LOW)
    lo2 = svc.submit(x[1], priority=Priority.LOW)
    hi = svc.submit(x[2], priority=Priority.HIGH)   # evicts newest LOW
    shed = svc.result(lo2)
    assert shed is not None and shed.error == "shed"
    hi2 = svc.submit(x[3], priority=Priority.HIGH)  # evicts the last LOW
    assert svc.result(lo1).error == "shed"
    # a HIGH submit at a queue full of HIGH work cannot evict -> QueueFull
    with pytest.raises(QueueFull):
        svc.submit(x[4], priority=Priority.HIGH)
    assert svc.drain() == 2                          # the two HIGHs
    assert svc.result(hi).ok and svc.result(hi2).ok
    st = svc.stats()
    assert st["shed_count"] == 2 and st["rejected_count"] == 1


def test_queue_pressure_concurrent_submitters_reconcile():
    """QueueFull + priority shedding under concurrent flood: admitted +
    rejected == offered per class, every admitted rid reaches a terminal
    outcome, and zero requests vanish."""
    x, model = _model()
    svc = RiskService(_engine(model), max_batch=16, max_queue=24)
    svc.start()
    try:
        lo = flood(svc, 40, n_threads=3, priority=Priority.LOW, seed=0)
        hi = flood(svc, 40, n_threads=3, priority=Priority.HIGH, seed=9)
    finally:
        deadline = time.perf_counter() + 30.0
        while svc.stats()["queue_depth"] and time.perf_counter() < deadline:
            time.sleep(0.01)
        svc.stop()
    assert lo["admitted"] + lo["rejected"] == 120
    assert hi["admitted"] + hi["rejected"] == 120
    outcomes = {rid: svc.result(rid) for rid in lo["rids"] + hi["rids"]}
    assert all(r is not None for r in outcomes.values())   # zero silent loss
    n_ok = sum(r.ok for r in outcomes.values())
    n_shed = sum((not r.ok) and r.error == "shed"
                 for r in outcomes.values())
    st = svc.stats()
    assert n_ok == st["n_requests"]
    assert n_shed == st["shed_count"]
    assert n_ok + n_shed == lo["admitted"] + hi["admitted"]
    assert st["rejected_count"] == lo["rejected"] + hi["rejected"]
    # every shed victim was LOW (shed-low-first)
    assert all(outcomes[rid].ok for rid in hi["rids"])


# ---------------------------------------------------------------------------
# Fault injection: engine exceptions, retry/backoff, health transitions
# ---------------------------------------------------------------------------

def test_transient_engine_fault_recovers_via_retry():
    x, model = _model()
    chaos = ChaosEngine(_engine(model), seed=0)
    svc = RiskService(chaos, max_batch=8, retries=2,
                      retry_backoff_s=0.005)
    chaos.fail_next(1)
    rid = svc.submit(x[0])
    assert svc.drain() == 1               # retry absorbed the fault
    assert svc.result(rid).ok
    st = svc.stats()
    assert st["retry_count"] == 1
    assert st["engine_failures"] == 0
    assert st["health"] == "SERVING"      # recovered


def test_exhausted_retries_yield_error_responses_and_degraded():
    x, model = _model()
    chaos = ChaosEngine(_engine(model), seed=0)
    svc = RiskService(chaos, max_batch=8, retries=1,
                      retry_backoff_s=0.005, down_after=2)
    chaos.fail_next(100)
    rids = [svc.submit(x[i]) for i in range(3)]
    assert svc.drain() == 0
    for rid in rids:                      # per-request error responses
        resp = svc.result(rid)
        assert resp is not None and "EngineFault" in resp.error
    assert svc.health() == "DEGRADED"
    # a second consecutive failed batch crosses down_after -> DOWN
    rid = svc.submit(x[3])
    svc.drain()
    assert "EngineFault" in svc.result(rid).error
    assert svc.health() == "DOWN"
    # engine heals -> first good batch restores SERVING
    chaos._fail_queue = 0                 # cancel remaining scheduled
    rid = svc.submit(x[4])
    assert svc.drain() == 1
    assert svc.result(rid).ok
    assert svc.health() == "SERVING"


def test_background_thread_survives_engine_crash():
    """The drain thread must outlive a crashing engine: errors out the
    batch, stays alive, and serves again once the engine heals."""
    x, model = _model()
    chaos = ChaosEngine(_engine(model), seed=0)
    svc = RiskService(chaos, max_batch=4, retries=0,
                      retry_backoff_s=0.001)
    svc.start()
    try:
        chaos.fail_next(5)
        bad = [svc.submit(x[i]) for i in range(3)]
        bad_resps = [svc.wait(r, timeout=30.0) for r in bad]
        assert all("EngineFault" in r.error for r in bad_resps)
        assert svc.thread_alive
        chaos._fail_queue = 0             # heal
        deadline = time.perf_counter() + 30.0
        ok = None
        while time.perf_counter() < deadline:
            rid = svc.submit(x[5])
            resp = svc.wait(rid, timeout=30.0)
            if resp.ok:
                ok = resp
                break
        assert ok is not None and np.isfinite(ok.risk)
        assert svc.thread_alive
        assert svc.health() == "SERVING"
    finally:
        svc.stop()


def test_latency_spike_expires_deadlined_requests():
    """A spiked dispatch makes queued deadlines lapse; the next batch
    drops them at form time instead of scoring stale work."""
    x, model = _model()
    chaos = ChaosEngine(_engine(model), seed=0)
    svc = RiskService(chaos, max_batch=1)
    chaos.spike_next(1, dur_s=0.15)
    first = svc.submit(x[0])                          # batch 1: spiked
    tight = svc.submit(x[1], deadline_s=0.05)         # expires mid-spike
    loose = svc.submit(x[2], deadline_s=30.0)
    assert svc.drain() == 2                           # first + loose
    assert svc.result(first).ok and svc.result(loose).ok
    resp = svc.result(tight)
    assert resp is not None and resp.error == "deadline_exceeded"
    assert svc.stats()["expired_count"] == 1
    assert chaos.spikes_injected == 1


# ---------------------------------------------------------------------------
# Artifact integrity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["truncate", "flip"])
def test_corrupt_artifact_fails_loudly(tmp_path, mode):
    _, model = _model()
    path = model.save(str(tmp_path / "m"))
    SurvivalModel.load(path)                          # pristine loads
    corrupt_artifact(path, "base_cumhaz", mode=mode)
    with pytest.raises(ArtifactCorrupt, match="base_cumhaz"):
        SurvivalModel.load(path)


def test_missing_leaf_fails_loudly(tmp_path):
    _, model = _model()
    path = model.save(str(tmp_path / "m"))
    (tmp_path / "m" / "beta.npy").unlink()
    with pytest.raises(ArtifactCorrupt, match="missing leaf beta"):
        SurvivalModel.load(path)


def test_format1_manifest_without_checksums_still_loads(tmp_path):
    import json
    import os
    _, model = _model()
    path = model.save(str(tmp_path / "m"))
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["format"] = 1
    for spec in manifest["arrays"].values():
        spec.pop("sha256", None)
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    loaded = SurvivalModel.load(path)                 # back-compat
    np.testing.assert_array_equal(loaded.beta, model.beta)


def test_registry_rejects_corrupt_artifact_keeps_live_engine(tmp_path):
    x, model = _model()
    svc = RiskService(_engine(model), max_batch=8)
    reg = ModelRegistry(svc, engine_factory=_engine, prewarm_batches=(1,))
    reg.load("v1", model)
    reg.swap("v1")
    path = model.save(str(tmp_path / "v2"))
    corrupt_artifact(path, "beta", mode="truncate")
    with pytest.raises(ArtifactCorrupt):
        reg.load("v2", path)
    assert reg.get("v2").state == "failed"
    assert reg.status()["live"] == "v1"               # untouched
    rid = svc.submit(x[0])
    svc.drain()
    assert svc.result(rid).ok                         # still serving


# ---------------------------------------------------------------------------
# Registry: lifecycle, generations, hot-swap under load
# ---------------------------------------------------------------------------

def test_registry_lifecycle_and_generations():
    x, model = _model(seed=0)
    _, model2 = _model(seed=1, scale=0.8)
    svc = RiskService(_engine(model), max_batch=8)
    reg = ModelRegistry(svc, engine_factory=_engine, prewarm_batches=(1, 8))
    e1 = reg.load("v1", model)
    assert e1.state == READY and e1.compiles >= 1     # warmed
    assert reg.swap("v1") == 1
    assert reg.get("v1").state == LIVE
    assert reg.rollout("v2", model2) == 2
    assert reg.status()["live"] == "v2"
    assert reg.get("v1").state == UNLOADED
    assert reg.get("v1").engine is None               # built queries dropped
    with pytest.raises(ValueError, match="live"):
        reg.unload("v2")
    with pytest.raises(KeyError):
        reg.swap("nope")
    # served scores now come from v2's coefficients
    rid = svc.submit(x[0])
    svc.drain()
    expect = _engine(model2).risk_scores(x[:1])[0]
    np.testing.assert_allclose(svc.result(rid).risk, expect, rtol=1e-6)


def test_registry_background_load_then_swap():
    _, model = _model(seed=0)
    _, model2 = _model(seed=1)
    svc = RiskService(_engine(model), max_batch=8)
    reg = ModelRegistry(svc, engine_factory=_engine, prewarm_batches=(1,))
    reg.load("bg", model2, block=False)
    entry = reg.wait_ready("bg", timeout=60.0)
    assert entry.state == READY
    assert reg.swap("bg") == 1
    assert svc.engine is entry.engine


def test_prewarm_compiles_buckets_ahead():
    _, model = _model()
    eng = _engine(model)
    n = eng.prewarm(batch_sizes=(1, 3, 64), kinds=("score",))
    # buckets 1, 4, 64 -> three compilations, then zero on re-warm
    assert n == 3
    assert eng.prewarm(batch_sizes=(1, 3, 64), kinds=("score",)) == 0
    before = eng.compiles
    eng.score(np.zeros((64, eng.feature_dim), np.float32))
    assert eng.compiles == before                     # live call: no compile


def test_hot_swap_under_load_drops_nothing():
    """Satellite/acceptance: swap mid-traffic; every submitted request
    resolves ok (no drops, no errors), scores flip to the new model, and
    the generation counter advances."""
    x, model = _model(seed=0)
    _, model2 = _model(seed=1, scale=0.9)
    svc = RiskService(_engine(model), max_batch=8)
    reg = ModelRegistry(svc, engine_factory=_engine, prewarm_batches=(1, 8))
    reg.load("v1", model)
    reg.swap("v1")
    svc.start()
    rids = []
    stop = threading.Event()

    def produce():
        rng = np.random.default_rng(0)
        while not stop.is_set():
            rids.append(svc.submit(
                rng.standard_normal(8).astype(np.float32)))
            time.sleep(0.001)

    producer = threading.Thread(target=produce)
    producer.start()
    try:
        time.sleep(0.05)
        gen = reg.rollout("v2", model2)               # swap under load
        time.sleep(0.05)
    finally:
        stop.set()
        producer.join()
        deadline = time.perf_counter() + 30.0
        while svc.stats()["queue_depth"] and time.perf_counter() < deadline:
            time.sleep(0.01)
        svc.stop()
    assert gen == 2
    responses = [svc.result(rid) for rid in rids]
    assert all(r is not None for r in responses)      # zero silent loss
    assert all(r.ok for r in responses)               # zero errors/drops
    st = svc.stats()
    assert st["n_requests"] == len(rids)
    assert st["engine_swaps"] == 2                    # v1 swap + rollout
    assert svc.health() == "SERVING"


# ---------------------------------------------------------------------------
# Results lifecycle: TTL sweep bounds a long-running service
# ---------------------------------------------------------------------------

def test_result_ttl_sweep_evicts_uncollected():
    x, model = _model()
    svc = RiskService(_engine(model), max_batch=8,
                      result_ttl_s=0.05)
    rids = [svc.submit(x[i]) for i in range(4)]
    svc.drain()
    assert svc.stats()["results_pending"] == 4
    time.sleep(0.1)
    # next step sweeps: a fresh request's batch-form triggers it
    svc._last_sweep = 0.0                 # make the sweep eligible now
    keep = svc.submit(x[5])
    svc.drain()
    st = svc.stats()
    assert st["results_evicted"] == 4
    assert all(svc.result(r) is None for r in rids)
    assert svc.result(keep).ok


def test_wait_is_condition_signaled_not_polled():
    """A waiter wakes promptly when the background loop posts the result
    — well under the loop's idle poll interval, which a sleep-poll wait
    could not beat reliably."""
    x, model = _model()
    svc = RiskService(_engine(model), max_batch=4)
    svc.submit(x[0])
    svc.drain()                           # build the bucket
    svc.start(poll_s=0.5)                 # long idle poll on purpose
    try:
        t0 = time.perf_counter()
        rid = svc.submit(x[1])
        resp = svc.wait(rid, timeout=30.0)
        dt = time.perf_counter() - t0
    finally:
        svc.stop()
    assert resp.ok
    # submit notifies the loop and step notifies the waiter: end-to-end
    # must land far below the 0.5s poll interval
    assert dt < 0.4, f"wait took {dt:.3f}s - condition signaling broken?"


# ---------------------------------------------------------------------------
# The seeded fault stream is the reference's own
# ---------------------------------------------------------------------------

class _Echo:
    """A stand-in engine: answers every call, so only the injector fails."""

    def score(self, x, strata=None, with_curves=False):
        return x


@pytest.mark.parametrize("error_rate,spike_rate", [(0.3, 0.0),
                                                   (0.25, 0.5)])
def test_seeded_chaos_fails_the_same_calls_as_jax(error_rate, spike_rate):
    def faults(chaos, fault):
        failed = []
        for i in range(300):
            if i % 50 == 0:
                chaos.fail_next(2)        # the schedule interleaves the RNG
            try:
                chaos.score(i)
            except fault:
                failed.append(i)
        return failed, chaos.faults_injected, chaos.spikes_injected

    kw = dict(seed=7, error_rate=error_rate, spike_rate=spike_rate,
              spike_s=0.0)
    got = faults(ChaosEngine(_Echo(), **kw), EngineFault)
    want = faults(JChaosEngine(_Echo(), **kw), JEngineFault)
    assert got == want
    assert 0 < len(got[0]) < 300
    assert (got[2] > 0) == (spike_rate > 0)
