"""Cox proportional hazards: losses, exact partial derivatives, Lipschitz
constants (Theorem 3.1 / Corollary 3.3 / Theorem 3.4 of FastSurvival).

The PyTorch counterpart of the JAX package's ``core/cox.py``; the same
conventions hold. All functions operate on *time-sorted* data. With
samples sorted ascending, the risk set ``R_i = {j : t_j >= t_i}`` is the
suffix starting at ``risk_start[i]`` (Breslow ties: every member of a tie
group shares the group's first index), so every risk-set statistic is a
reverse (suffix) cumulative sum gathered at ``risk_start``.

  w_k  = exp(eta_k - max eta)                (stabilized hazards)
  S0_i = revcumsum(w)[risk_start[i]]
  A_k  = cumsum(delta / S0)[tie_end[k]]
  B_k  = cumsum(delta / S0^2)[tie_end[k]]
  grad      = X^T (w * A) - X^T delta
  hess_diag = X^T.^2 (w * A) - sum_i delta_i * M_i.^2,
              M_i = revcumsum(w * X)[risk_start[i]] / S0_i
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from .. import device as _device

Tensor = torch.Tensor

INV_6_SQRT3 = 1.0 / (6.0 * math.sqrt(3.0))


@dataclasses.dataclass(frozen=True)
class CoxData:
    """Time-sorted survival design matrix and risk-set indexing."""

    x: Tensor           # (n, p) features, sorted ascending by time
    xT: Tensor          # (p, n) contiguous transpose: the rows CD walks
    delta: Tensor       # (n,)   event indicator in {0., 1.}, sorted
    risk_start: Tensor  # (n,)   int32: first index of each sample's tie group
    tie_end: Tensor     # (n,)   int32: last index of each sample's tie group

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def p(self) -> int:
        return self.x.shape[1]

    @property
    def device(self) -> torch.device:
        return self.x.device


def prepare(x, t, delta, device="cuda") -> CoxData:
    """Sort by time ascending and build Breslow tie-group indices.

    ``x``, ``t`` and ``delta`` are tensors or arrays; ``x`` keeps its float
    type and ``delta`` takes it. Raises without CUDA unless ``device`` is
    ``"cpu"``."""
    dev = _device.resolve(device)
    x = torch.as_tensor(x, device=dev)
    t = torch.as_tensor(t, device=dev)
    delta = torch.as_tensor(delta, device=dev).to(x.dtype)
    order = torch.argsort(t, stable=True)
    ts = t[order].contiguous()
    risk_start = torch.searchsorted(ts, ts, side="left").to(torch.int32)
    tie_end = (torch.searchsorted(ts, ts, side="right") - 1).to(torch.int32)
    xs = x[order].contiguous()
    return CoxData(x=xs, xT=xs.T.contiguous(), delta=delta[order].contiguous(),
                   risk_start=risk_start, tie_end=tie_end)


def with_x(data: CoxData, x: Tensor) -> CoxData:
    """``data`` with the time-sorted feature panel ``x`` (n, p') in place of
    its own, and the contiguous transpose that CD walks made from it."""
    return dataclasses.replace(data, x=x, xT=x.T.contiguous())


def revcumsum(v: Tensor, axis: int = 0) -> Tensor:
    """Reverse (suffix) cumulative sum along ``axis``."""
    return torch.flip(torch.cumsum(torch.flip(v, (axis,)), axis), (axis,))


def _gather(v: Tensor, idx: Tensor) -> Tensor:
    return v[idx.long()]


# ---------------------------------------------------------------------------
# Shared risk-set statistics
# ---------------------------------------------------------------------------

def hazard_weights(eta: Tensor) -> Tuple[Tensor, Tensor]:
    """Stabilized w = exp(eta - m); returns (w, m)."""
    m = torch.max(eta).detach()
    return torch.exp(eta - m), m


def risk_stats(data: CoxData, eta: Tensor
               ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Return (w, s0, a, b) — the O(n) sufficient statistics.

    s0_i = sum_{j in R_i} w_j           (at each sample's risk_start)
    a_k  = sum_{i : t_i <= t_k} delta_i / s0_i
    b_k  = sum_{i : t_i <= t_k} delta_i / s0_i^2
    """
    w, _ = hazard_weights(eta)
    s0 = _gather(revcumsum(w), data.risk_start)
    d1 = data.delta / s0
    a = _gather(torch.cumsum(d1, 0), data.tie_end)
    b = _gather(torch.cumsum(d1 / s0, 0), data.tie_end)
    return w, s0, a, b


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def loss_from_eta(data: CoxData, eta: Tensor) -> Tensor:
    """Negative log partial likelihood (Breslow ties), Eq. (4)."""
    m = torch.max(eta)
    w = torch.exp(eta - m)
    log_s0 = torch.log(_gather(revcumsum(w), data.risk_start)) + m
    return torch.sum(data.delta * (log_s0 - eta))


def penalty(beta: Tensor, lam1, lam2) -> Tensor:
    return lam1 * torch.sum(torch.abs(beta)) + lam2 * torch.sum(beta * beta)


def objective(data: CoxData, beta: Tensor, lam1: float = 0.0,
              lam2: float = 0.0) -> Tensor:
    eta = data.x @ beta
    return loss_from_eta(data, eta) + penalty(beta, lam1, lam2)


def eta_gradient(data: CoxData, eta: Tensor) -> Tensor:
    """d loss / d eta (n,): w*A - delta. Used by deep survival heads."""
    w, _, a, _ = risk_stats(data, eta)
    return w * a - data.delta


# ---------------------------------------------------------------------------
# All-coordinate derivatives (swapped-order GEMV form)
# ---------------------------------------------------------------------------

def grad_all(data: CoxData, eta: Tensor) -> Tensor:
    """Exact gradient for all p coordinates in O(np) via two GEMVs."""
    return data.x.T @ eta_gradient(data, eta)


def grad_hess_all(data: CoxData, eta: Tensor) -> Tuple[Tensor, Tensor]:
    """Exact (grad, diag Hessian) for all p coordinates, O(np)."""
    w, s0, a, _ = risk_stats(data, eta)
    wa = w * a
    grad = data.x.T @ (wa - data.delta)
    term1 = (data.x * data.x).T @ wa
    mean = _gather(revcumsum(w[:, None] * data.x, 0),
                   data.risk_start) / s0[:, None]
    term2 = (data.delta[:, None] * mean * mean).sum(dim=0)
    return grad, term1 - term2


def exact_hessian(data: CoxData, eta: Tensor) -> Tensor:
    """Full (p, p) Hessian in O(n p^2) without materializing the (n, n)
    sample-space Hessian:  X^T diag(w*A) X  -  sum_i delta_i m_i m_i^T."""
    w, s0, a, _ = risk_stats(data, eta)
    h1 = (data.x * (w * a)[:, None]).T @ data.x
    mean = _gather(revcumsum(w[:, None] * data.x, 0),
                   data.risk_start) / s0[:, None]
    mw = mean * torch.sqrt(data.delta)[:, None]
    return h1 - mw.T @ mw


def eta_hessian_diag(data: CoxData, eta: Tensor) -> Tensor:
    """Diagonal of the sample-space Hessian nabla^2_eta loss (n,):
    w_k A_k - w_k^2 B_k."""
    w, _, a, b = risk_stats(data, eta)
    return w * a - (w * w) * b


def eta_hessian_upper(data: CoxData, eta: Tensor) -> Tensor:
    """Diagonal majorant of nabla^2_eta loss: w*A (>= the true diagonal)."""
    w, _, a, _ = risk_stats(data, eta)
    return w * a


# ---------------------------------------------------------------------------
# Per-coordinate derivatives (Theorem 3.1) — the paper's CD primitives
# ---------------------------------------------------------------------------

def coord_derivs(data: CoxData, eta: Tensor, xl: Tensor,
                 order: int = 2) -> Tuple[Tensor, Tensor, Tensor]:
    """(g, h, c3) = 1st/2nd/3rd partial at one coordinate, each O(n).

    ``xl`` is the (n,) feature column (time-sorted). ``order`` 3 also forms
    the third partial; otherwise c3 is 0."""
    w, _ = hazard_weights(eta)
    s0 = _gather(revcumsum(w), data.risk_start)
    m1 = _gather(revcumsum(w * xl), data.risk_start) / s0
    g = torch.sum(data.delta * (m1 - xl))
    m2 = _gather(revcumsum(w * xl * xl), data.risk_start) / s0
    h = torch.sum(data.delta * (m2 - m1 * m1))
    if order < 3:
        return g, h, torch.zeros_like(g)
    m3 = _gather(revcumsum(w * xl * xl * xl), data.risk_start) / s0
    c3 = torch.sum(data.delta * (m3 + 2.0 * m1 ** 3 - 3.0 * m2 * m1))
    return g, h, c3


# ---------------------------------------------------------------------------
# Lipschitz constants (Theorem 3.4) — beta-independent, precomputed once
# ---------------------------------------------------------------------------

def lipschitz_constants(data: CoxData) -> Tuple[Tensor, Tensor]:
    """(L2, L3), each (p,): L2 bounds the 2nd partial, L3 the |3rd| partial.

    L2_l = 1/4      sum_i delta_i (max_{k in R_i} X_kl - min_{k in R_i})^2
    L3_l = 1/(6√3)  sum_i delta_i |range|^3
    """
    flipped = torch.flip(data.x, (0,))
    smax = torch.flip(torch.cummax(flipped, 0).values, (0,))
    smin = torch.flip(torch.cummin(flipped, 0).values, (0,))
    rng = _gather(smax, data.risk_start) - _gather(smin, data.risk_start)
    d = data.delta[:, None]
    l2 = 0.25 * torch.sum(d * rng * rng, dim=0)
    l3 = INV_6_SQRT3 * torch.sum(d * rng * rng * rng, dim=0)
    return l2, l3


def central_moment(data: CoxData, eta: Tensor, xl: Tensor, r: int) -> Tensor:
    """C_r of Lemma 3.2 for every event i (n,), O(n * r).

    Reference implementation used by tests of the moment recursion
    dC_r/dbeta_l = C_{r+1} - r C_2 C_{r-1}."""
    w, _ = hazard_weights(eta)
    s0 = _gather(revcumsum(w), data.risk_start)
    m1 = _gather(revcumsum(w * xl), data.risk_start) / s0
    # E[(X - mu)^r] = sum_j binom(r,j) E[X^j] (-mu)^(r-j)
    out = torch.zeros_like(s0)
    for j in range(r + 1):
        ej = _gather(revcumsum(w * xl ** j), data.risk_start) / s0
        out = out + math.comb(r, j) * ej * (-m1) ** (r - j)
    return out
