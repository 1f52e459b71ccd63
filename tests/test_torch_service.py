"""Port's serving/service.py: the continuous-batching RiskService over the
port's ScoringEngine on the CPU. The reference's own service checks
(tests/test_serving.py) with the same timing margins, then one stream of
requests through both packages' services, stepped by hand.

Tolerances: a risk the service returns is the engine's float32 exp(x beta)
at another bucket, so 1e-6 relative as the reference holds it; a curve
against its closed form 1e-5 relative and 1e-6 absolute (the reference's);
the two packages' float32 risks 1e-5 relative and curves 1e-5 absolute
(float32 matmuls and exps in different libraries); medians and error
strings equal."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import QueueFull as JQueueFull  # noqa: E402
from repro.serving import RiskService as JService  # noqa: E402
from repro.serving import ScoringEngine as JEngine  # noqa: E402
from repro.serving import SurvivalModel as JModel  # noqa: E402
from repro.serving import fit_survival_model as j_fit  # noqa: E402
from repro_torch.data.synthetic import make_tied_survival  # noqa: E402
from repro_torch.serving import (Priority, QueueFull,  # noqa: E402
                                 RiskService, ScoreTimeout, ScoringEngine,
                                 SurvivalModel, fit_survival_model)

RISK_RTOL = 1e-6          # the reference's, service against engine
# the reference's, against the closed form
CURVE_RTOL, CURVE_ATOL = 1e-5, 1e-6
PARITY_RISK_RTOL = 1e-5   # float32 risks, JAX against torch
PARITY_CURVE_ATOL = 1e-5  # float32 probabilities, JAX against torch


def _problem(n=200, p=8, seed=0):
    x, t, delta = make_tied_survival(n=n, p=p, seed=seed)
    rng = np.random.default_rng(seed + 1)
    beta = (rng.standard_normal(p) * 0.4).astype(np.float32)
    return (x.astype(np.float32), t.astype(np.float32),
            delta.astype(np.float32), beta)


def _fit(*args, **kw):
    return fit_survival_model(*args, device="cpu", **kw)


def _engine(model):
    return ScoringEngine(model, device="cpu")


# ---------------------------------------------------------------------------
# The reference's service checks (tests/test_serving.py)
# ---------------------------------------------------------------------------

def test_service_scores_match_engine_and_buckets():
    x, t, delta, beta = _problem(n=180, p=8)
    eng = _engine(_fit(x, t, delta, beta))
    svc = RiskService(eng, max_batch=16, return_curves=True)
    rids = [svc.submit(x[i]) for i in range(50)]
    served = svc.drain()
    assert served == 50
    risks = eng.risk_scores(x[:50])
    meds = eng.median_survival(x[:50])
    for i, rid in enumerate(rids):
        resp = svc.result(rid)
        assert resp is not None
        np.testing.assert_allclose(resp.risk, risks[i], rtol=RISK_RTOL)
        assert resp.median == meds[i] or (np.isinf(resp.median)
                                          and np.isinf(meds[i]))
        assert resp.curve is not None and resp.curve.shape == (128,)
        assert resp.latency_s >= 0.0
    st = svc.stats()
    assert st["n_requests"] == 50
    assert st["n_batches"] >= 4          # 50 reqs / max_batch 16
    assert st["latency_p99_ms"] >= st["latency_p50_ms"]


def test_service_background_thread():
    x, t, delta, beta = _problem(n=120, p=6)
    svc = RiskService(_engine(_fit(x, t, delta, beta)), max_batch=8)
    svc.start()
    try:
        rids = [svc.submit(x[i]) for i in range(20)]
        outs = [svc.wait(rid, timeout=60.0) for rid in rids]
    finally:
        svc.stop()
    assert not svc.thread_alive
    assert len(outs) == 20
    assert all(np.isfinite(o.risk) for o in outs)


def test_service_stratified_requests():
    x, t, delta, beta = _problem(n=200, p=8)
    strata = np.random.default_rng(11).integers(0, 2, size=len(t))
    model = _fit(x, t, delta, beta, strata=strata)
    svc = RiskService(_engine(model), max_batch=8, return_curves=True)
    r0 = svc.submit(x[0], stratum=0)
    r1 = svc.submit(x[0], stratum=1)
    svc.drain()
    c0 = svc.result(r0).curve
    c1 = svc.result(r1).curve
    # same features, different baselines -> different curves
    assert not np.allclose(c0, c1)
    expect = np.exp(-model.base_cumhaz
                    * np.exp(np.clip(x[0] @ beta, -30, 30)))
    np.testing.assert_allclose(c0, expect[0], rtol=CURVE_RTOL,
                               atol=CURVE_ATOL)
    np.testing.assert_allclose(c1, expect[1], rtol=CURVE_RTOL,
                               atol=CURVE_ATOL)


def test_service_result_hands_over_once():
    x, t, delta, beta = _problem(n=100, p=6)
    svc = RiskService(_engine(_fit(x, t, delta, beta)), max_batch=4)
    rid = svc.submit(x[0])
    svc.drain()
    assert svc.result(rid) is not None
    assert svc.result(rid) is None      # popped: no unbounded accumulation
    assert svc.stats()["n_requests"] == 1


def test_stats_keys_present_on_fresh_service():
    x, t, delta, beta = _problem(n=80, p=6)
    svc = RiskService(_engine(_fit(x, t, delta, beta)))
    st = svc.stats()
    for key in ("n_requests", "wall_s", "reqs_per_s", "n_batches",
                "mean_batch", "queue_depth", "rejected_count",
                "timeout_count", "latency_p50_ms", "latency_p99_ms",
                "engine", "shed_count", "expired_count", "error_count",
                "retry_count", "engine_failures", "results_evicted",
                "results_pending", "engine_swaps", "health"):
        assert key in st, key
    assert st["n_requests"] == 0
    assert st["queue_depth"] == 0
    assert st["rejected_count"] == 0
    assert st["latency_p50_ms"] == 0.0
    assert st["latency_p99_ms"] == 0.0
    assert np.isnan(st["reqs_per_s"])
    assert st["health"] == "SERVING"
    assert st["engine"] == {"entries": 0, "compiles": 0, "calls": 0,
                            "shard": 1}


def test_wait_timeout_raises_score_timeout_and_abandons():
    x, t, delta, beta = _problem(n=80, p=6)
    svc = RiskService(_engine(_fit(x, t, delta, beta)))
    rid = svc.submit(x[0])          # never stepped: no serving thread
    with pytest.raises(ScoreTimeout) as ei:
        svc.wait(rid, timeout=0.05)
    assert ei.value.rid == rid
    assert str(rid) in str(ei.value)
    assert svc.stats()["timeout_count"] == 1
    # abandoned: the queued copy is dropped at batch-form time (no device
    # work wasted) and no response accumulates for it
    assert svc.drain() == 0
    assert svc.result(rid) is None
    assert svc.stats()["results_evicted"] == 1
    assert svc.stats()["results_pending"] == 0
    assert svc.engine.calls == 0


def test_bounded_queue_sheds_with_queue_full():
    x, t, delta, beta = _problem(n=80, p=6)
    svc = RiskService(_engine(_fit(x, t, delta, beta)), max_queue=2)
    svc.submit(x[0])
    svc.submit(x[1])
    with pytest.raises(QueueFull):
        svc.submit(x[2])
    st = svc.stats()
    assert st["rejected_count"] == 1
    assert st["queue_depth"] == 2
    assert svc.drain() == 2         # shed request never enters a batch


def test_concurrent_submit_step_stats():
    """Producers, the serving thread, and a stats poller all hammering the
    service concurrently: every request is scored exactly once and the
    counters reconcile."""
    x, t, delta, beta = _problem(n=200, p=8)
    svc = RiskService(_engine(_fit(x, t, delta, beta)), max_batch=16)
    svc.start()
    n_threads, per_thread = 4, 25
    rids = [[] for _ in range(n_threads)]
    stats_seen = []
    stop_polling = threading.Event()

    def produce(slot):
        rng = np.random.default_rng(slot)
        for _ in range(per_thread):
            rids[slot].append(
                svc.submit(rng.standard_normal(8).astype(np.float32)))

    def poll():
        while not stop_polling.is_set():
            stats_seen.append(svc.stats())

    threads = [threading.Thread(target=produce, args=(s,))
               for s in range(n_threads)]
    poller = threading.Thread(target=poll)
    poller.start()
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(60.0)
        outs = [svc.wait(rid, timeout=60.0)
                for slot in rids for rid in slot]
    finally:
        stop_polling.set()
        poller.join(60.0)
        svc.stop()
    assert not any(th.is_alive() for th in threads + [poller])
    total = n_threads * per_thread
    assert len(outs) == total
    assert all(np.isfinite(o.risk) for o in outs)
    flat = [rid for slot in rids for rid in slot]
    assert len(set(flat)) == total
    assert [o.rid for o in outs] == flat
    st = svc.stats()
    assert st["n_requests"] == total
    assert st["timeout_count"] == 0 and st["rejected_count"] == 0
    assert st["queue_depth"] == 0
    assert stats_seen, "poller never ran"
    served_seq = [s["n_requests"] for s in stats_seen]
    assert served_seq == sorted(served_seq)
    assert all("latency_p99_ms" in s for s in stats_seen)


# ---------------------------------------------------------------------------
# One request stream through both packages' services
# ---------------------------------------------------------------------------

def _drive(svc, queue_full, x, n_strata, seed):
    """A seeded stream of submits and hand-stepped batches; returns every
    submit's outcome in order: ("rid", rid) or ("QueueFull", None).
    ``queue_full`` is the service's package's ``QueueFull``."""
    rng = np.random.default_rng(seed)
    outcomes = []
    for _ in range(4):
        for _ in range(int(rng.integers(20, 40))):
            i = int(rng.integers(0, len(x)))
            prio = Priority.HIGH if rng.random() < 0.25 else Priority.LOW
            # about one in eight is already past its deadline on arrival
            deadline = -1.0 if rng.random() < 0.125 else None
            stratum = int(rng.integers(0, n_strata))
            try:
                outcomes.append(("rid", svc.submit(
                    x[i], stratum, priority=prio, deadline_s=deadline)))
            except queue_full:
                outcomes.append(("QueueFull", None))
        for _ in range(int(rng.integers(1, 3))):
            svc.step()
    svc.drain()
    return outcomes


@pytest.mark.parametrize("n_strata", [1, 3])
def test_step_stream_matches_jax(tmp_path, n_strata):
    x, t, delta, beta = _problem(n=240, p=12)
    strata = (np.random.default_rng(5).integers(0, n_strata, size=len(t))
              if n_strata > 1 else None)
    path = j_fit(x, t, delta, beta, strata=strata).save(
        str(tmp_path / "model"))
    kw = dict(max_batch=16, max_queue=24, return_curves=True)
    got_svc = RiskService(_engine(SurvivalModel.load(path)), **kw)
    want_svc = JService(JEngine(JModel.load(path)), **kw)
    got = _drive(got_svc, QueueFull, x, n_strata, seed=17)
    want = _drive(want_svc, JQueueFull, x, n_strata, seed=17)
    assert got == want
    kinds = {"ok": 0, "shed": 0, "deadline_exceeded": 0}
    for kind, rid in got:
        if kind != "rid":
            continue
        g, w = got_svc.result(rid), want_svc.result(rid)
        assert g is not None and w is not None, rid
        assert g.rid == w.rid == rid
        assert g.error == w.error, rid
        kinds[g.error or "ok"] += 1
        if w.ok:
            np.testing.assert_allclose(g.risk, w.risk,
                                       rtol=PARITY_RISK_RTOL)
            np.testing.assert_allclose(g.curve, np.asarray(w.curve),
                                       rtol=0, atol=PARITY_CURVE_ATOL)
            assert g.median == w.median, rid
        else:
            assert np.isnan(g.risk) and g.curve is None
    # the stream reaches every outcome the admission layer has
    assert all(kinds.values()), kinds
    assert ("QueueFull", None) in got
    gs, ws = got_svc.stats(), want_svc.stats()
    for key in ("n_requests", "n_batches", "mean_batch", "expired_count",
                "shed_count", "rejected_count", "error_count",
                "queue_depth", "results_pending"):
        assert gs[key] == ws[key], key
