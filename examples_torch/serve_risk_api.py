"""End-to-end risk API on the port: beam-search CPH -> artifact ->
registry serving.

Fits a cardinality-constrained model with the paper's beam-search CD,
packages it as a SurvivalModel artifact (k-sparse beta + Breslow baseline
on a time grid), round-trips it through save/load (sha256-verified), and
serves risk / median-survival queries through the continuous-batching
RiskService fronted by a ModelRegistry: the engine is checksum-loaded
and prewarmed before going live, queries carry priorities and
server-side deadlines, and a retrained model is hot-swapped into the
live slot mid-traffic with zero dropped requests. The PyTorch twin of
``examples/serve_risk_api.py``, on a card unless ``--device cpu``.

Telemetry is on: spans go to ``$REPRO_TRACE_FILE`` when set, else to
``serve_risk_api_trace.jsonl`` in the working directory (replaced), and
the run ends with the per-stage latency-breakdown table (queue wait vs
batch formation vs dispatch) rendered from that file.

    PYTHONPATH=src python examples_torch/serve_risk_api.py [--device cpu]
"""
import argparse
import functools
import os
import tempfile

from repro_torch.launch import runtime

runtime.apply()   # env policy before torch initializes

import numpy as np  # noqa: E402

from repro_torch import device  # noqa: E402
from repro_torch.analysis.report import latency_breakdown_table  # noqa: E402
from repro_torch.core import beam, cox  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    SyntheticSpec, make_correlated_survival)
from repro_torch.obs import trace  # noqa: E402
from repro_torch.serving import (ModelRegistry, Priority,  # noqa: E402
                                 RiskService, ScoringEngine, SurvivalModel,
                                 fit_survival_model)


def main(argv=None) -> list:
    """Returns every submitted request's ``ScoreResponse``, in order."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device.resolve(args.device)

    trace_path = os.environ.get("REPRO_TRACE_FILE",
                                "serve_risk_api_trace.jsonl")
    if not os.environ.get("REPRO_TRACE_FILE") and os.path.exists(trace_path):
        os.remove(trace_path)
    trace.configure(trace_path)
    print(f"[trace] spans -> {trace_path}")
    try:
        responses = _run(dev)
    finally:
        trace.configure(None)
    print("\nPer-stage latency breakdown (telemetry spans):\n")
    print(latency_breakdown_table(trace_path))
    return responses


def _run(dev) -> list:
    runtime.log()
    spec = SyntheticSpec(n=400, p=120, k=4, rho=0.7, seed=3,
                         censor_scale=3.0)
    x, t, delta, beta_star = make_correlated_survival(spec)
    data = cox.prepare(x, t, delta, device=dev)
    k = int((beta_star != 0).sum())

    print(f"[fit] beam search, n={spec.n} p={spec.p} k={k}")
    res = beam.beam_search(data, k=k, beam_width=4, n_expand=6, device=dev)
    beta = res.betas[-1]
    print(f"[fit] support={np.flatnonzero(beta).tolist()} "
          f"loss={res.losses[-1]:.2f}")

    model = fit_survival_model(x, t, delta, beta, device=dev)
    with tempfile.TemporaryDirectory() as d:
        path = model.save(d + "/model")
        model = SurvivalModel.load(path)   # sha256-verified per leaf
    print(f"[artifact] p={model.p} k={model.k} grid={model.n_grid} "
          f"ties={model.ties} (save/load round-trip ok, checksums verified)")

    service = RiskService(None, max_batch=32, return_curves=False)
    registry = ModelRegistry(  # sparse fast path auto-selected
        service, engine_factory=functools.partial(ScoringEngine, device=dev))
    entry = registry.load("champ", model)  # verify + build + warm buckets
    registry.swap("champ")                 # atomic promote to the live slot
    print(f"[registry] live={registry.live_id} "
          f"gen={registry.generation} warm_compiles={entry.compiles}")
    service.start()

    rng = np.random.default_rng(0)
    queries = rng.standard_normal((100, spec.p)).astype(np.float32)
    rids = [service.submit(q,
                           priority=(Priority.HIGH if i % 4 == 0
                                     else Priority.LOW),
                           deadline_s=None if i % 4 == 0 else 2.0)
            for i, q in enumerate(queries)]
    # hot-swap a retrained candidate mid-traffic: load + warm happen off
    # the serving path; queued requests score on the new engine, zero drops
    retrained = fit_survival_model(x, t, delta,
                                   (beta * 0.95).astype(np.float32),
                                   device=dev)
    registry.rollout("retrain", retrained)
    rids += [service.submit(q, priority=Priority.HIGH) for q in queries[:20]]
    responses = [service.wait(rid) for rid in rids]
    service.stop()

    st = service.stats()
    print(f"[serve] {st['n_requests']} requests in {st['wall_s']*1e3:.1f}ms "
          f"({st['reqs_per_s']:.0f} req/s, mean batch "
          f"{st['mean_batch']:.1f}, p50 {st['latency_p50_ms']:.2f}ms, "
          f"p99 {st['latency_p99_ms']:.2f}ms, queue_depth "
          f"{st['queue_depth']}, rejected {st['rejected_count']}, "
          f"shed {st['shed_count']}, expired {st['expired_count']}, "
          f"errors {st['error_count']}, timeouts {st['timeout_count']})")
    print(f"[serve] health={service.health()} engine_swaps="
          f"{st['engine_swaps']} live={registry.live_id} "
          f"gen={registry.generation}")
    ok = [r for r in responses if r.ok]
    print(f"[serve] {len(ok)}/{len(responses)} scored ok "
          f"(every submitted rid reached a terminal outcome)")
    for r in ok[:3]:
        med = "inf" if np.isinf(r.median) else f"{r.median:.3f}"
        print(f"  req {r.rid}: risk={r.risk:.3f} median_survival={med} "
              f"trace={r.trace_id}")
    return responses


if __name__ == "__main__":
    main()
