"""Coordinate descent on the quadratic and cubic surrogates (the paper's
``cd_quad`` and ``cd_cubic``, Eq. 15-22), and the streaming fit.

The PyTorch counterpart of ``fit_cd``, ``fit_cd_tol`` and ``fit_stream``
in the JAX package's ``core/solvers.py``. All minimize
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
from ..obs import solver as obs_solver
from . import cox, streaming, surrogate

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
              groups: Optional[Tensor]) -> None:
    """One full sweep over all p coordinates, in order; updates eta and
    beta in place. ``groups`` (the fit's ``ops.group_events``)
    routes each coordinate through the kernel; None takes the plain
    path."""
    for l in range(data.p):
        xl = data.xT[l]
        if groups is not None:
            g, h = ops.cox_coord_grad_hess(eta, xl, data.delta,
                                           data.risk_start, groups)
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
           use_kernel: bool, device
           ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Optional[Tensor]]:
    """Validate the call; return (eta, beta, L2, L3) at the start point and,
    when ``use_kernel``, the tie groups' event counts that the Lipschitz
    pass and every ``cox_coord`` call of the fit take (None on the plain
    path)."""
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
        groups = ops.group_events(data.delta, data.risk_start)
        l2c, l3c = ops.lipschitz_constants(data.x, data.delta,
                                           data.risk_start, groups)
    else:
        l2c, l3c = cox.lipschitz_constants(data)
        groups = None
    return eta, beta, l2c, l3c, groups


def fit_cd(data: cox.CoxData, lam1: float = 0.0, lam2: float = 0.0,
           n_iters: int = 100, beta0: Optional[Tensor] = None,
           method: str = "cd_quad", use_kernel: bool = True,
           device="cuda") -> FitResult:
    """FastSurvival coordinate descent (quadratic or cubic surrogate).

    ``data`` must lie on ``device``, which must be a card unless it is
    ``"cpu"``. ``use_kernel`` routes the per-coordinate derivatives and
    the Lipschitz constants through the kernels (their plain versions on
    the CPU)."""
    eta, beta, l2c, l3c, groups = _start(data, beta0, method, use_kernel,
                                         device)
    cubic = method == "cd_cubic"
    objs = []
    for _ in range(n_iters):
        _cd_sweep(data, eta, beta, l2c, l3c, lam1, lam2, cubic, groups)
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
    eta, beta, l2c, l3c, groups = _start(data, beta0, method, use_kernel,
                                         device)
    cubic = method == "cd_cubic"
    cur = _objective(data, eta, beta, lam1, lam2)
    prev = float(cur) + 2.0 * tol + 1.0
    it = 0
    while it < max_iters and prev - float(cur) > tol:
        prev = float(cur)
        _cd_sweep(data, eta, beta, l2c, l3c, lam1, lam2, cubic, groups)
        cur = _objective(data, eta, beta, lam1, lam2)
        it += 1
    return FitResult(beta=beta, objective=cur.reshape(1), n_iters=it)


# ---------------------------------------------------------------------------
# Streaming diagonal-Newton fit (BigSurvSGD-style): the large-n path
# ---------------------------------------------------------------------------

def fit_stream(source, lam1: float = 0.0, lam2: float = 0.0,
               n_epochs: int = 200, tol: float = 0.0, mode: str = "global",
               beta0: Optional[Tensor] = None, telemetry=None,
               use_kernel: bool = True, max_backtracks: int = 30,
               device="cuda") -> FitResult:
    """Streaming proximal diagonal-Newton fit over a chunk source.

    ``source`` is any indexable of ``streaming.Chunk``s (``len`` and
    ``[i]``); the full design matrix is never formed. Each epoch streams
    the chunks through ``core/streaming.py``'s carried suffix-sum
    statistics, so the working set is one chunk plus O(n) vectors. Chunks
    may lie anywhere (numpy arrays included) and are moved to ``device``
    when touched; ``device`` must be a card unless it is ``"cpu"``.

    ``mode="global"`` minimizes the exact full-stream partial likelihood
    (chunks globally time-sorted and tie-free), so it converges to
    ``fit_cd``'s optimum; ``mode="chunk"`` is the BigSurvSGD estimand, each
    chunk its own stratum.

    The update is an all-coordinates quadratic prox step at the exact
    diagonal Hessian, with objective backtracking: the diagonal is not a
    majorizer, so the step scale halves until the streamed objective does
    not rise, and ``telemetry`` (an ``obs.TelemetryCallback``) can watch
    that live. The fixed point is unchanged by the damping.

    ``use_kernel`` routes the work through the kernels: in global mode the
    suffix scans of the gradient, the Hessian and every loss evaluation
    (``revcumsum``; the reference's loss evaluations ignore its
    ``use_kernel``, ROADMAP C4), in chunk mode each chunk's gradient and
    Hessian (``cox_batch``; its loss is plain torch, as in the reference).
    ``use_kernel=False`` is plain torch throughout.
    The host waits on the device only to read the objectives that the
    backtracking compares, as the reference does.
    """
    dev = _device.resolve(device)
    if mode == "global":
        grad_hess = streaming.streaming_grad_hess
        loss_fn = streaming.streaming_loss
    elif mode == "chunk":
        grad_hess = streaming.stratified_grad_hess

        def loss_fn(src, b, use_kernel=True):
            return streaming.stratified_loss(src, b)
    else:
        raise ValueError(f"unknown mode: {mode!r}")

    first = torch.as_tensor(source[0].x[:0])
    p, dtype = first.shape[1], first.dtype
    if beta0 is None:
        beta = torch.zeros(p, dtype=dtype, device=dev)
    else:
        beta = torch.as_tensor(beta0, dtype=dtype, device=dev).clone()
    obj = (loss_fn(source, beta, use_kernel=use_kernel)
           + cox.penalty(beta, lam1, lam2))
    objs = []
    step_scale = 1.0
    it = -1
    for it in range(n_epochs):
        g_s, h_s, _ = grad_hess(source, beta, use_kernel=use_kernel)
        g = g_s + 2.0 * lam2 * beta
        h = torch.clamp(h_s + 2.0 * lam2, min=1e-12)
        cand, new_obj = beta, obj
        for _ in range(max_backtracks):
            step = surrogate.quad_l1_prox(g, h / step_scale, beta, lam1)
            cand = beta + step
            new_obj = (loss_fn(source, cand, use_kernel=use_kernel)
                       + cox.penalty(cand, lam1, lam2))
            if float(new_obj) <= float(obj):
                break
            step_scale *= 0.5
        else:
            objs.append(obj)   # no descent step left: converged
            break
        prev, beta, obj = obj, cand, new_obj
        objs.append(obj)
        if telemetry is not None:
            obs_solver.emit_iter(telemetry, it, obj, torch.linalg.norm(g),
                                 torch.linalg.norm(step),
                                 torch.sum(beta != 0))
        step_scale = min(step_scale * 2.0, 1.0)
        if tol > 0.0 and float(prev) - float(obj) < tol:
            break
    objective = (torch.stack(objs) if objs
                 else torch.zeros(0, dtype=dtype, device=dev))
    return FitResult(beta=beta, objective=objective, n_iters=it + 1)
