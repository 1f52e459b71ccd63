"""Coordinate descent on the quadratic and cubic surrogates (the paper's
``cd_quad`` and ``cd_cubic``, Eq. 15-22), the Section-2 baselines, the
nonconvex-penalty CD and the streaming fit.

The PyTorch counterpart of the JAX package's ``core/solvers.py``. All
minimize loss(beta) + lam1 ||beta||_1 + lam2 ||beta||_2^2 (``fit_newton``
has no lam1, ``fit_cd_penalized`` puts SCAD or MCP in its place) and
return the objective trace, so the paper's Fig. 1 and App. D comparisons
can be drawn from either package.

On a card each coordinate's (g, h) comes from the fused ``cox_coord``
kernel and the Theorem-3.4 constants from the ``lipschitz`` kernel, once
per fit; ``use_kernel=False`` takes the plain ``cox.coord_derivs`` and
``cox.lipschitz_constants`` instead, for comparisons. Both are exact on
tied times. The prox step stays on the device: nothing inside a sweep
waits on the host. ``eta`` and ``beta`` are updated in place.

Baselines (Section 2): ``fit_newton`` (exact Newton, optionally with
Armijo backtracking), ``fit_working_newton`` (glmnet's ``quasi`` and
skglm's ``prox`` diagonal sample-space models, inner CD) and ``fit_gd``
(ISTA with the global step 1/sum(L2)). Their large products (``grad_all``,
``exact_hessian``, ``x @ beta``) are ``torch.matmul``, as the reference
leaves them to XLA outside any Pallas kernel.

Telemetry: every fit function takes ``telemetry`` (an
``obs.TelemetryCallback`` or None). When set, each outer iteration sends
(objective, norm of the smooth part's gradient, ||step||, nnz(beta)) to
it, which reads them on the host and counts objective increases beyond
its tol. ``telemetry=None`` (the default) costs nothing: no gradient, no
copy of beta, no wait on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .. import device as _device
from ..kernels import ops
from ..obs import solver as obs_solver
from . import cox, penalties, streaming, surrogate

Tensor = torch.Tensor
METHODS = ("cd_quad", "cd_cubic")


@dataclasses.dataclass
class FitResult:
    beta: Tensor        # (p,)
    objective: Tensor   # (n_iters,) objective after each outer iteration
    n_iters: int        # outer iterations run


def _objective(data: cox.CoxData, eta: Tensor, beta: Tensor, lam1,
               lam2) -> Tensor:
    return cox.loss_from_eta(data, eta) + cox.penalty(beta, lam1, lam2)


def _trace(objs, beta: Tensor) -> Tensor:
    return (torch.stack(objs) if objs
            else torch.zeros(0, dtype=beta.dtype, device=beta.device))


def _prev(beta: Tensor, telemetry) -> Optional[Tensor]:
    """A copy of beta for ``_emit``'s step norm; None without telemetry,
    so a fit without it copies nothing."""
    return None if telemetry is None else beta.clone()


def _emit(telemetry, data: cox.CoxData, it: int, eta: Tensor, beta: Tensor,
          beta_prev: Optional[Tensor], obj: Tensor, lam2) -> None:
    """Send one outer iteration to ``telemetry``; nothing when it is None.

    The gradient norm is of the smooth part (loss + l2), which every solver
    here has, l1 or not; its ``grad_all`` is paid only when telemetry is
    on."""
    if telemetry is None:
        return
    g = cox.grad_all(data, eta) + 2.0 * lam2 * beta
    obs_solver.emit_iter(telemetry, it, obj, torch.linalg.norm(g),
                         torch.linalg.norm(beta - beta_prev),
                         torch.sum(beta != 0))


def _start(data: cox.CoxData, beta0: Optional[Tensor], device) -> Tensor:
    """Check that ``data`` lies on ``device`` (a card unless ``"cpu"``);
    return the start point, a copy of ``beta0`` or zeros."""
    _device.expect(data, device)
    if beta0 is None:
        return torch.zeros(data.p, dtype=data.x.dtype, device=data.device)
    return torch.as_tensor(beta0, dtype=data.x.dtype,
                           device=data.device).clone()


def constants(data: cox.CoxData, use_kernel: bool
              ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """(L2, L3) of every column and, when ``use_kernel``, the tie groups'
    event counts that the ``lipschitz`` pass and every ``cox_coord`` call of
    a fit take (None on the plain path)."""
    if not use_kernel:
        return (*cox.lipschitz_constants(data), None)
    groups = ops.group_events(data.delta, data.risk_start)
    return (*ops.lipschitz_constants(data.x, data.delta, data.risk_start,
                                     groups), groups)


def coord_grad_hess(data: cox.CoxData, eta: Tensor, xl: Tensor,
                    groups: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """(g, h) of the coordinate whose column is ``xl``: by the ``cox_coord``
    kernel given a fit's ``groups``, by ``cox.coord_derivs`` given None."""
    if groups is not None:
        return ops.cox_coord_grad_hess(eta, xl, data.delta, data.risk_start,
                                       groups)
    g, h, _ = cox.coord_derivs(data, eta, xl, order=2)
    return g, h


def coord_step(data: cox.CoxData, eta: Tensor, rows: Tensor, j: int,
               prev: Optional[int], beta: Tensor, curv: Tensor, step: Tensor,
               groups: Tensor, lam2: float) -> None:
    """One quadratic-surrogate coordinate step of C candidate supports at
    once, in place (``beam.finetune_batch``'s): eta (C, n), rows (C, s, n)
    the candidates' columns, beta and curv (C, s), step (C,) the steps
    last taken. The step pending from column ``prev`` (None: none) is
    applied first, eta[c] += rows[c, prev] * step[c]; then column j's
    ``quad_min`` step goes into beta[:, j] and step. On a card that is one
    fused ``ops.cox_coord_step`` (two launches, nothing read back);
    elsewhere the same step in eager ops over ``coord_grad_hess``, the
    fused step's plain version, which each candidate's (g, h) reaches as
    every other solver's do."""
    if eta.is_cuda:
        ops.cox_coord_step(eta, rows, j, prev, beta, curv, step, data.delta,
                           groups, lam2)
        return
    if prev is not None:
        eta.addcmul_(rows[:, prev], step[:, None])
    g, _ = coord_grad_hess(data, eta, rows[:, j].contiguous(), groups)
    d = surrogate.quad_min(g + 2.0 * lam2 * beta[:, j], curv[:, j])
    beta[:, j] += d
    step.copy_(d)


def _cd_sweep(data: cox.CoxData, eta: Tensor, beta: Tensor, l2c: Tensor,
              l3c: Tensor, lam1, lam2, cubic: bool,
              groups: Optional[Tensor]) -> None:
    """One full sweep over all p coordinates, in order; updates eta and
    beta in place. ``groups`` (the fit's ``ops.group_events``)
    routes each coordinate through the kernel; None takes the plain
    path."""
    for l in range(data.p):
        xl = data.xT[l]
        g, h = coord_grad_hess(data, eta, xl, groups)
        bl = beta[l]
        a = g + 2.0 * lam2 * bl
        if cubic:
            step = surrogate.cubic_l1_prox(a, h + 2.0 * lam2, l3c[l], bl,
                                           lam1)
        else:
            step = surrogate.quad_l1_prox(a, l2c[l] + 2.0 * lam2, bl, lam1)
        bl.add_(step)
        eta.addcmul_(xl, step)


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")


def fit_cd(data: cox.CoxData, lam1: float = 0.0, lam2: float = 0.0,
           n_iters: int = 100, beta0: Optional[Tensor] = None,
           method: str = "cd_quad", use_kernel: bool = True,
           telemetry=None, device="cuda") -> FitResult:
    """FastSurvival coordinate descent (quadratic or cubic surrogate).

    ``data`` must lie on ``device``, which must be a card unless it is
    ``"cpu"``. ``use_kernel`` routes the per-coordinate derivatives and
    the Lipschitz constants through the kernels (their plain versions on
    the CPU)."""
    beta = _start(data, beta0, device)
    _check_method(method)
    eta = data.x @ beta
    l2c, l3c, groups = constants(data, use_kernel)
    cubic = method == "cd_cubic"
    objs = []
    for it in range(n_iters):
        beta_prev = _prev(beta, telemetry)
        _cd_sweep(data, eta, beta, l2c, l3c, lam1, lam2, cubic, groups)
        objs.append(_objective(data, eta, beta, lam1, lam2))
        _emit(telemetry, data, it, eta, beta, beta_prev, objs[-1], lam2)
    return FitResult(beta=beta, objective=_trace(objs, beta),
                     n_iters=n_iters)


def fit_cd_tol(data: cox.CoxData, lam1: float = 0.0, lam2: float = 0.0,
               max_iters: int = 200, tol: float = 1e-7,
               beta0: Optional[Tensor] = None, method: str = "cd_quad",
               use_kernel: bool = True, telemetry=None,
               device="cuda") -> FitResult:
    """Early-stopping variant: stops when the objective decrease over one
    sweep falls below ``tol`` (sound, since the surrogate majorization
    makes the objective monotone). Reads the objective on the host once a
    sweep; ``objective`` holds the last value only."""
    beta = _start(data, beta0, device)
    _check_method(method)
    eta = data.x @ beta
    l2c, l3c, groups = constants(data, use_kernel)
    cubic = method == "cd_cubic"
    cur = _objective(data, eta, beta, lam1, lam2)
    prev = float(cur) + 2.0 * tol + 1.0
    it = 0
    while it < max_iters and prev - float(cur) > tol:
        prev = float(cur)
        beta_prev = _prev(beta, telemetry)
        _cd_sweep(data, eta, beta, l2c, l3c, lam1, lam2, cubic, groups)
        cur = _objective(data, eta, beta, lam1, lam2)
        _emit(telemetry, data, it, eta, beta, beta_prev, cur, lam2)
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
    return FitResult(beta=beta, objective=_trace(objs, beta),
                     n_iters=it + 1)


# ---------------------------------------------------------------------------
# Newton-type baselines (Section 2)
# ---------------------------------------------------------------------------

def _newton_direction(data: cox.CoxData, eta: Tensor, beta: Tensor,
                      lam2) -> Tuple[Tensor, Tensor]:
    g = cox.grad_all(data, eta) + 2.0 * lam2 * beta
    eye = torch.eye(data.p, dtype=eta.dtype, device=eta.device)
    h = cox.exact_hessian(data, eta) + 2.0 * lam2 * eye
    h = h + 1e-9 * eye
    d, info = torch.linalg.solve_ex(h, -g)
    # a singular Hessian (a diverged iterate's holds inf or NaN) gives a
    # non-finite direction, as jnp.linalg.solve does, and no exception:
    # the objective trace shows the divergence
    return torch.where(info == 0, d, torch.nan), g


def fit_newton(data: cox.CoxData, lam2: float = 0.0, n_iters: int = 50,
               beta0: Optional[Tensor] = None, line_search: bool = False,
               telemetry=None, device="cuda") -> FitResult:
    """Exact Newton (lam1 unsupported, as in the paper). ``line_search=True``
    adds Armijo backtracking, a host loop that reads the objective, and
    serves as the high-precision reference."""
    beta = _start(data, beta0, device)
    objs = []
    for it in range(n_iters):
        beta_prev = _prev(beta, telemetry)
        eta = data.x @ beta
        d, g = _newton_direction(data, eta, beta, lam2)
        if line_search:
            f0 = float(_objective(data, eta, beta, 0.0, lam2))
            gd = float(g @ d)
            t = 1.0
            cand = beta + d
            f = float(_objective(data, data.x @ cand, cand, 0.0, lam2))
            while f > f0 + 1e-4 * t * gd and t > 1e-8:
                t *= 0.5
                cand = beta + t * d
                f = float(_objective(data, data.x @ cand, cand, 0.0, lam2))
            beta = beta + t * d
        else:
            beta = beta + d
        eta = data.x @ beta
        objs.append(_objective(data, eta, beta, 0.0, lam2))
        _emit(telemetry, data, it, eta, beta, beta_prev, objs[-1], lam2)
    return FitResult(beta=beta, objective=_trace(objs, beta),
                     n_iters=n_iters)


def _inner_cd_quadratic(data: cox.CoxData, dvec: Tensor, g: Tensor,
                        beta: Tensor, lam1, lam2, sweeps: int) -> Tensor:
    """Solve min_D g^T D + 1/2 D^T X^T diag(dvec) X D + pen(beta + D) by CD.

    Keeps r = diag(dvec) X D, so each coordinate costs O(n) (a few eager
    ops); this is the glmnet inner loop (all-coefficients-at-once
    quadratic model)."""
    q = torch.clamp((data.x * data.x * dvec[:, None]).sum(0), min=1e-12)
    delta = torch.zeros_like(beta)
    r = torch.zeros_like(dvec)
    for _ in range(sweeps):
        for l in range(data.p):
            xl = data.xT[l]
            c = beta[l] + delta[l]
            a = g[l] + xl @ r + 2.0 * lam2 * c
            step = surrogate.quad_l1_prox(a, q[l] + 2.0 * lam2, c, lam1)
            delta[l].add_(step)
            r.add_((step * dvec) * xl)
    return delta


WORKING_VARIANTS = ("quasi", "prox")


def fit_working_newton(data: cox.CoxData, lam1: float = 0.0,
                       lam2: float = 0.0, n_iters: int = 50,
                       beta0: Optional[Tensor] = None,
                       variant: str = "quasi", inner_sweeps: int = 3,
                       telemetry=None, device="cuda") -> FitResult:
    """quasi_newton (Simon et al. 2011: the sample-space Hessian's diagonal)
    and prox_newton (skglm: its diagonal majorant w*A) baselines."""
    beta = _start(data, beta0, device)
    if variant not in WORKING_VARIANTS:
        raise ValueError(f"variant must be one of {WORKING_VARIANTS}, got "
                         f"{variant!r}")
    hess = (cox.eta_hessian_diag if variant == "quasi"
            else cox.eta_hessian_upper)
    objs = []
    for it in range(n_iters):
        beta_prev = _prev(beta, telemetry)
        eta = data.x @ beta
        g = cox.grad_all(data, eta)
        dvec = torch.clamp(hess(data, eta), min=1e-12)
        beta = beta + _inner_cd_quadratic(data, dvec, g, beta, lam1, lam2,
                                          inner_sweeps)
        eta = data.x @ beta
        objs.append(_objective(data, eta, beta, lam1, lam2))
        _emit(telemetry, data, it, eta, beta, beta_prev, objs[-1], lam2)
    return FitResult(beta=beta, objective=_trace(objs, beta),
                     n_iters=n_iters)


def fit_gd(data: cox.CoxData, lam1: float = 0.0, lam2: float = 0.0,
           n_iters: int = 200, beta0: Optional[Tensor] = None,
           telemetry=None, use_kernel: bool = True,
           device="cuda") -> FitResult:
    """Proximal gradient (ISTA) with the paper-derived global step 1/L,
    L = sum_l L2_l + 2 lam2 (a trace bound on the Hessian's spectrum).
    ``use_kernel`` takes L2 from the ``lipschitz`` kernel."""
    beta = _start(data, beta0, device)
    l2c, _, _ = constants(data, use_kernel)
    lr = 1.0 / (torch.sum(l2c) + 2.0 * lam2 + 1e-12)
    objs = []
    for it in range(n_iters):
        beta_prev = _prev(beta, telemetry)
        eta = data.x @ beta
        g = cox.grad_all(data, eta) + 2.0 * lam2 * beta
        z = beta - lr * g
        beta = torch.sign(z) * torch.clamp(torch.abs(z) - lr * lam1, min=0.0)
        eta = data.x @ beta
        objs.append(_objective(data, eta, beta, lam1, lam2))
        _emit(telemetry, data, it, eta, beta, beta_prev, objs[-1], lam2)
    return FitResult(beta=beta, objective=_trace(objs, beta),
                     n_iters=n_iters)


# name -> fit(data, lam1, lam2, n_iters, beta0=None, **keywords such as
# device="cpu"), in the reference's argument order
SOLVERS = {
    "cd_quad": lambda data, lam1, lam2, n, b0=None, **kw: fit_cd(
        data, lam1, lam2, n, b0, method="cd_quad", **kw),
    "cd_cubic": lambda data, lam1, lam2, n, b0=None, **kw: fit_cd(
        data, lam1, lam2, n, b0, method="cd_cubic", **kw),
    "newton": lambda data, lam1, lam2, n, b0=None, **kw: fit_newton(
        data, lam2, n, b0, line_search=False, **kw),
    "newton_ls": lambda data, lam1, lam2, n, b0=None, **kw: fit_newton(
        data, lam2, n, b0, line_search=True, **kw),
    "quasi_newton": lambda data, lam1, lam2, n, b0=None, **kw:
        fit_working_newton(data, lam1, lam2, n, b0, variant="quasi", **kw),
    "prox_newton": lambda data, lam1, lam2, n, b0=None, **kw:
        fit_working_newton(data, lam1, lam2, n, b0, variant="prox", **kw),
    "gd": lambda data, lam1, lam2, n, b0=None, **kw: fit_gd(
        data, lam1, lam2, n, b0, **kw),
}


def fit_cd_penalized(data: cox.CoxData, penalty: str = "scad",
                     lam1: float = 0.1, gamma: float = 3.7,
                     lam2: float = 0.0, n_iters: int = 100,
                     beta0: Optional[Tensor] = None, use_kernel: bool = True,
                     telemetry=None, device="cuda") -> FitResult:
    """Quadratic-surrogate CD with nonconvex separable penalties (SCAD /
    MCP, the §3.5 extensions): the coordinate machinery of ``cd_quad``
    with the penalty's prox at the surrogate's Newton point. The objective
    trace is the true penalized objective; descent holds per coordinate
    because the prox minimizes the majorizer exactly."""
    prox = penalties.PROX[penalty]
    pval = penalties.VALUE[penalty]
    beta = _start(data, beta0, device)
    eta = data.x @ beta
    l2c, _, groups = constants(data, use_kernel)
    objs = []
    for it in range(n_iters):
        beta_prev = _prev(beta, telemetry)
        for l in range(data.p):
            xl = data.xT[l]
            g, _ = coord_grad_hess(data, eta, xl, groups)
            bl = beta[l]
            step = prox(g + 2.0 * lam2 * bl, l2c[l] + 2.0 * lam2, bl, lam1,
                        gamma)
            bl.add_(step)
            eta.addcmul_(xl, step)
        objs.append(cox.loss_from_eta(data, eta)
                    + lam2 * torch.sum(beta * beta) + pval(beta, lam1, gamma))
        _emit(telemetry, data, it, eta, beta, beta_prev, objs[-1], lam2)
    return FitResult(beta=beta, objective=_trace(objs, beta),
                     n_iters=n_iters)
