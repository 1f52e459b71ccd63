"""Regularization paths (coxnet-style l1 / elastic-net) with warm starts.

The PyTorch counterpart of the JAX package's ``core/path.py``. Used both
as a user-facing feature and as the LASSO-path baseline of the
variable-selection benchmarks (an SksurvCoxnet analogue, solved with the
monotone CD of ``solvers.fit_cd``, so it cannot blow up). Every fit runs
on ``device`` with ``fit_cd``'s kernels unless ``use_kernel=False``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as _device
from . import cox, solvers


@dataclasses.dataclass
class PathResult:
    lambdas: np.ndarray
    betas: np.ndarray          # (n_lambda, p)
    losses: np.ndarray         # unpenalized CPH loss
    support_sizes: np.ndarray


def lambda_max(data: cox.CoxData) -> float:
    """Smallest lam1 for which beta = 0 is optimal: max |grad_l(0)|."""
    eta0 = torch.zeros(data.n, dtype=data.x.dtype, device=data.device)
    return float(torch.max(torch.abs(cox.grad_all(data, eta0))))


def l1_path(data: cox.CoxData, n_lambdas: int = 30,
            lambda_min_ratio: float = 0.01, lam2: float = 0.0,
            n_iters: int = 80, method: str = "cd_quad",
            use_kernel: bool = True, device="cuda") -> PathResult:
    """``fit_cd`` at ``n_lambdas`` geometric steps of lam1 from just under
    ``lambda_max`` down to ``lambda_min_ratio`` of it, each warm-started at
    the previous solution."""
    _device.expect(data, device)
    lmax = lambda_max(data)
    lams = np.geomspace(lmax * 0.999, lmax * lambda_min_ratio, n_lambdas)
    betas, losses, sizes = [], [], []
    beta = torch.zeros(data.p, dtype=data.x.dtype, device=data.device)
    for lam1 in lams:
        res = solvers.fit_cd(data, lam1=float(lam1), lam2=lam2,
                             n_iters=n_iters, beta0=beta, method=method,
                             use_kernel=use_kernel, device=device)
        beta = res.beta
        b = beta.cpu().numpy()
        betas.append(b)
        losses.append(float(cox.loss_from_eta(data, data.x @ beta)))
        sizes.append(int((np.abs(b) > 1e-8).sum()))
    return PathResult(lambdas=lams, betas=np.stack(betas),
                      losses=np.asarray(losses),
                      support_sizes=np.asarray(sizes))


def adaptive_lasso(data: cox.CoxData, lam1: float, lam2: float = 1e-3,
                   n_rounds: int = 3, n_iters: int = 80,
                   use_kernel: bool = True, device="cuda") -> np.ndarray:
    """Adaptive-LASSO baseline (Zhang & Lu 2007): reweighted l1 where each
    round's weights are 1/|beta_prev|. Implemented by column rescaling so
    the inner problem stays a vanilla l1 fit."""
    fit = dict(lam1=lam1, lam2=lam2, n_iters=n_iters, use_kernel=use_kernel,
               device=device)
    beta = solvers.fit_cd(data, **fit).beta.cpu().numpy()
    for _ in range(n_rounds - 1):
        wts = 1.0 / np.maximum(np.abs(beta), 1e-3)
        scale = 1.0 / wts
        col = torch.as_tensor(scale, dtype=data.x.dtype, device=data.device)
        res = solvers.fit_cd(cox.with_x(data, data.x * col[None, :]), **fit)
        beta = res.beta.cpu().numpy() * scale
    return beta
