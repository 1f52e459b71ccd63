"""Quickstart: FastSurvival CPH training on the port, in ~50 lines.

Generates the paper's Appendix-C synthetic data, fits the CPH model with
the quadratic- and cubic-surrogate coordinate descent, compares against the
Newton baselines on the same objective, and evaluates CIndex/F1. The
PyTorch twin of ``examples/quickstart.py``, on a card unless ``--device
cpu``.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import device
from repro_torch.core import cox, solvers
from repro_torch.data.synthetic import SyntheticSpec, make_correlated_survival
from repro_torch.survival import metrics

METHODS = ("cd_quad", "cd_cubic", "quasi_newton", "prox_newton",
           "newton_ls", "gd")


def main(argv=None) -> dict:
    """Returns each method's final objective, the CIndex and the l1 fit's
    support size and F1."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device.resolve(args.device)

    spec = SyntheticSpec(n=1000, p=100, k=8, rho=0.7, seed=0)
    x, t, delta, beta_star = make_correlated_survival(spec)
    data = cox.prepare(x, t, delta, device=dev)
    print(f"n={spec.n} p={spec.p} events={int(delta.sum())}")

    results, out = {}, {}
    for method in METHODS:
        res = solvers.SOLVERS[method](data, 0.0, 1.0, 60, device=dev)
        obj = res.objective.cpu().numpy()
        results[method] = res
        out[method] = float(obj[-1])
        mono = "monotone" if np.all(np.diff(obj) <= 1e-7) else "NON-MONOTONE"
        print(f"{method:>14}: final objective {obj[-1]:.6f}  [{mono}]")

    beta = results["cd_quad"].beta.cpu().numpy()
    risk = x @ beta
    out["cindex"] = ci = metrics.cindex(t, delta, risk)
    print(f"\ncd_quad: CIndex {ci:.4f}")

    # l1-regularized sparse fit
    res = solvers.fit_cd(data, lam1=5.0, lam2=1.0, n_iters=100, device=dev)
    b = res.beta.cpu().numpy()
    p_, r_, f1 = metrics.support_f1(beta_star, b)
    out["l1_support"] = int((np.abs(b) > 1e-8).sum())
    out["l1_f1"] = f1
    print(f"l1 fit: support {out['l1_support']}, "
          f"F1 vs true support {f1:.3f}")
    return out


if __name__ == "__main__":
    main()
