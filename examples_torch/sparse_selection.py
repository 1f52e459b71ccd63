"""Cardinality-constrained variable selection (paper Fig. 2 regime) on the
port.

Beam-search CD on highly correlated synthetic data (rho = 0.9) versus the
L1 path and a gradient-scored greedy OMP baseline; reports F1 per support
size and shows ours dominating under correlation. The PyTorch twin of
``examples/sparse_selection.py``, on a card unless ``--device cpu``.

    PYTHONPATH=src python examples_torch/sparse_selection.py [--device cpu]
"""
import argparse

from repro_torch import device
from repro_torch.core import beam, cox, path
from repro_torch.data.synthetic import SyntheticSpec, make_correlated_survival
from repro_torch.survival import metrics


def main(argv=None) -> list:
    """Returns the table's rows: (support size, beam F1, OMP F1, best-l1
    F1)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device.resolve(args.device)

    spec = SyntheticSpec(n=600, p=120, k=6, rho=0.9, seed=3)
    x, t, delta, beta_star = make_correlated_survival(spec)
    data = cox.prepare(x, t, delta, device=dev)
    k_true = int((beta_star != 0).sum())
    print(f"n={spec.n} p={spec.p} rho={spec.rho} true support={k_true}")

    res_beam = beam.beam_search(data, k=k_true + 2, beam_width=5, n_expand=8,
                                device=dev)
    res_omp = beam.omp_greedy(data, k=k_true + 2, device=dev)
    res_l1 = path.l1_path(data, n_lambdas=20, lambda_min_ratio=0.02,
                          device=dev)

    rows = []
    print("\nsupport size | beam F1 | omp F1 | best-l1 F1")
    for k in range(1, k_true + 3):
        _, _, f_b = metrics.support_f1(beta_star, res_beam.betas[k - 1])
        _, _, f_o = metrics.support_f1(beta_star, res_omp.betas[k - 1])
        f_l = 0.0
        for b, s in zip(res_l1.betas, res_l1.support_sizes):
            if s == k:
                f_l = max(f_l, metrics.support_f1(beta_star, b)[2])
        rows.append((k, f_b, f_o, f_l))
        print(f"{k:12d} | {f_b:7.3f} | {f_o:6.3f} | {f_l:10.3f}")
    return rows


if __name__ == "__main__":
    main()
