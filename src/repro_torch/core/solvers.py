"""Coordinate descent on the quadratic and cubic surrogates (the paper's
``cd_quad`` and ``cd_cubic``, Eq. 15-22).

The PyTorch counterpart of ``fit_cd`` and ``fit_cd_tol`` in the JAX
package's ``core/solvers.py``. Both minimize
loss(beta) + lam1 ||beta||_1 + lam2 ||beta||_2^2.

On a card each coordinate's (g, h) comes from the fused ``cox_coord``
kernel and the Theorem-3.4 constants from the ``lipschitz`` kernel, once
per fit; ``use_kernel=False`` takes the plain ``cox.coord_derivs`` and
``cox.lipschitz_constants`` instead, for comparisons. Both are exact on
tied times. The prox step stays on the device: nothing inside a sweep
waits on the host. ``eta`` and ``beta`` are updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .. import device as _device
from ..kernels import ops
from . import cox, surrogate

Tensor = torch.Tensor
METHODS = ("cd_quad", "cd_cubic")


@dataclasses.dataclass
class FitResult:
    beta: Tensor        # (p,)
    objective: Tensor   # (n_iters,) objective after each sweep
    n_iters: int        # sweeps run


def _objective(data: cox.CoxData, eta: Tensor, beta: Tensor, lam1,
               lam2) -> Tensor:
    return cox.loss_from_eta(data, eta) + cox.penalty(beta, lam1, lam2)


def _cd_sweep(data: cox.CoxData, eta: Tensor, beta: Tensor, l2c: Tensor,
              l3c: Tensor, lam1, lam2, cubic: bool,
              use_kernel: bool) -> None:
    """One full sweep over all p coordinates, in order; updates eta and
    beta in place."""
    for l in range(data.p):
        xl = data.xT[l]
        if use_kernel:
            g, h = ops.cox_coord_grad_hess(eta, xl, data.delta,
                                           data.risk_start)
        else:
            g, h, _ = cox.coord_derivs(data, eta, xl, order=2)
        bl = beta[l]
        a = g + 2.0 * lam2 * bl
        if cubic:
            step = surrogate.cubic_l1_prox(a, h + 2.0 * lam2, l3c[l], bl,
                                           lam1)
        else:
            step = surrogate.quad_l1_prox(a, l2c[l] + 2.0 * lam2, bl, lam1)
        bl.add_(step)
        eta.addcmul_(xl, step)


def _start(data: cox.CoxData, beta0: Optional[Tensor], method: str,
           use_kernel: bool, device) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Validate the call; return (eta, beta, L2, L3) at the start point."""
    dev = _device.resolve(device)
    if data.device.type != dev.type:
        raise ValueError(f"data lies on {data.device}, the fit was asked to "
                         f"run on {dev}; prepare it there")
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    if beta0 is None:
        beta = torch.zeros(data.p, dtype=data.x.dtype, device=data.device)
    else:
        beta = torch.as_tensor(beta0, dtype=data.x.dtype,
                               device=data.device).clone()
    eta = data.x @ beta
    if use_kernel:
        l2c, l3c = ops.lipschitz_constants(data.x, data.delta,
                                           data.risk_start)
    else:
        l2c, l3c = cox.lipschitz_constants(data)
    return eta, beta, l2c, l3c


def fit_cd(data: cox.CoxData, lam1: float = 0.0, lam2: float = 0.0,
           n_iters: int = 100, beta0: Optional[Tensor] = None,
           method: str = "cd_quad", use_kernel: bool = True,
           device="cuda") -> FitResult:
    """FastSurvival coordinate descent (quadratic or cubic surrogate).

    ``data`` must lie on ``device``, which must be a card unless it is
    ``"cpu"``. ``use_kernel`` routes the per-coordinate derivatives and
    the Lipschitz constants through the kernels (their plain versions on
    the CPU)."""
    eta, beta, l2c, l3c = _start(data, beta0, method, use_kernel, device)
    cubic = method == "cd_cubic"
    objs = []
    for _ in range(n_iters):
        _cd_sweep(data, eta, beta, l2c, l3c, lam1, lam2, cubic, use_kernel)
        objs.append(_objective(data, eta, beta, lam1, lam2))
    objective = (torch.stack(objs) if objs
                 else torch.zeros(0, dtype=beta.dtype, device=beta.device))
    return FitResult(beta=beta, objective=objective, n_iters=n_iters)


def fit_cd_tol(data: cox.CoxData, lam1: float = 0.0, lam2: float = 0.0,
               max_iters: int = 200, tol: float = 1e-7,
               beta0: Optional[Tensor] = None, method: str = "cd_quad",
               use_kernel: bool = True, device="cuda") -> FitResult:
    """Early-stopping variant: stops when the objective decrease over one
    sweep falls below ``tol`` (sound, since the surrogate majorization
    makes the objective monotone). Reads the objective on the host once a
    sweep; ``objective`` holds the last value only."""
    eta, beta, l2c, l3c = _start(data, beta0, method, use_kernel, device)
    cubic = method == "cd_cubic"
    cur = _objective(data, eta, beta, lam1, lam2)
    prev = float(cur) + 2.0 * tol + 1.0
    it = 0
    while it < max_iters and prev - float(cur) > tol:
        prev = float(cur)
        _cd_sweep(data, eta, beta, l2c, l3c, lam1, lam2, cubic, use_kernel)
        cur = _objective(data, eta, beta, lam1, lam2)
        it += 1
    return FitResult(beta=beta, objective=cur.reshape(1), n_iters=it)
