"""End-to-end driver on the port: train a Mamba2 backbone with the paper's
CPH objective (deep survival head), beam-search a sparse interpretable
head on the frozen features, export the result as a serving artifact, and
score it through the registry/service stack. The PyTorch twin of
``examples/train_survival_lm.py``, on a card unless ``--device cpu``.

Default runs the CPU-sized variant; pass --full for the ~100M config
(mamba2-130m at 12 layers).

    PYTHONPATH=src python examples_torch/train_survival_lm.py --steps 200
"""
import argparse
import functools
import os
import tempfile

import numpy as np

from repro_torch import device
from repro_torch.serving import ModelRegistry, RiskService, ScoringEngine
from repro_torch.survival import deep
from repro_torch.survival.metrics import cindex


def main(argv=None):
    """Returns ``deep.run``'s ``DeepSurvivalResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=48)
    ap.add_argument("--full", action="store_true",
                    help="~100M-param config instead of the CPU-sized one")
    ap.add_argument("--export", default="",
                    help="artifact directory (default: a temp dir)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device.resolve(args.device)

    dcfg = deep.DeepSurvivalConfig(steps=args.steps, batch=args.batch,
                                   seq=args.seq, full=args.full)
    cfg = deep.model_config(dcfg)
    print(f"[driver] arch={cfg.name} family={cfg.family} "
          f"d_model={cfg.d_model} objective=cox device={dev}")

    res = deep.run(dcfg, device=dev)
    print(f"[driver] nll first10 {np.mean(res.losses[:10]):.4f} -> "
          f"last10 {np.mean(res.losses[-10:]):.4f}")
    print(f"[driver] held-out CIndex deep {res.cindex_deep:.4f} "
          f"(0.5 = random, higher is better)")
    print(f"[driver] beam-search sparse head: {res.nnz} of {cfg.d_model} "
          f"features, CIndex {res.cindex_sparse:.4f}")

    # -- export + serve: the deep artifact rides the linear serving stack --
    export_dir = args.export or os.path.join(
        tempfile.mkdtemp(prefix="deep_survival_"), "artifact")
    res.artifact.save(export_dir)
    print(f"[driver] artifact saved -> {export_dir}")

    svc = RiskService(engine=None, max_batch=16)
    reg = ModelRegistry(svc, prewarm_batches=(1, 16),
                        engine_factory=functools.partial(ScoringEngine,
                                                         device=dev))
    reg.rollout("deep_v1", export_dir)     # checksum-verify + warm + swap
    svc.start()
    try:
        rids = [svc.submit(f) for f in res.features[:16]]
        served = np.array([svc.wait(r).risk for r in rids])
    finally:
        svc.stop()
    direct = np.exp(np.clip(res.features[:16] @ res.beta, -30.0, 30.0))
    np.testing.assert_allclose(served, direct, rtol=1e-4)
    ci_served = cindex(res.times, res.events,
                       np.asarray(reg.engine().risk_scores(res.features)))
    print(f"[driver] served {len(rids)} requests through "
          f"ModelRegistry/RiskService (gen {reg.generation}); "
          f"served CIndex {ci_served:.4f} — matches the sparse head")
    return res


if __name__ == "__main__":
    main()
