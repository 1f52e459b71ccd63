"""Survival evaluation metrics (Appendix C.2): Harrell's CIndex, Integrated
Brier Score with IPCW weighting and a Breslow baseline-hazard estimator, and
support-recovery precision/recall/F1. Host-side numpy (evaluation only).

A copy of the JAX package's ``survival/metrics.py`` (numpy only), kept so
that the port stands alone."""
from __future__ import annotations

import numpy as np


def cindex(t: np.ndarray, delta: np.ndarray, risk: np.ndarray,
           chunk: int = 4096) -> float:
    """Harrell's concordance index. Comparable pair: t_i < t_j with
    delta_i = 1; concordant if risk_i > risk_j; risk ties count 1/2.

    Pairs are enumerated in row chunks of ``chunk`` samples so peak host
    memory is O(chunk * n) instead of O(n^2); the counts are bitwise the
    same as the full broadcast."""
    t = np.asarray(t, np.float64)
    delta = np.asarray(delta).astype(bool)
    risk = np.asarray(risk, np.float64)
    n = len(t)
    n_comp = 0
    score = 0.0
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        comparable = (t[lo:hi, None] < t[None, :]) & delta[lo:hi, None]
        conc = (risk[lo:hi, None] > risk[None, :]) & comparable
        ties = np.isclose(risk[lo:hi, None], risk[None, :]) & comparable
        n_comp += int(comparable.sum())
        score += conc.sum() + 0.5 * ties.sum()
    if n_comp == 0:
        return 0.5
    return float(score / n_comp)


def km_censoring(t: np.ndarray, delta: np.ndarray):
    """Kaplan-Meier estimate of the *censoring* survival G(t) (IPCW)."""
    t = np.asarray(t, np.float64)
    cens = 1.0 - np.asarray(delta, np.float64)
    order = np.argsort(t)
    ts, cs = t[order], cens[order]
    uniq, start = np.unique(ts, return_index=True)
    n = len(ts)
    at_risk = n - start
    d = np.add.reduceat(cs, start)
    surv = np.cumprod(1.0 - d / np.maximum(at_risk, 1))

    def g(query):
        idx = np.searchsorted(uniq, query, side="right") - 1
        out = np.where(idx >= 0, surv[np.clip(idx, 0, len(surv) - 1)], 1.0)
        return np.maximum(out, 1e-8)

    return g


def breslow_baseline(t_train, delta_train, eta_train):
    """Breslow cumulative baseline hazard H0(t) = sum_{t_i<=t} d_i / S0_i."""
    t_train = np.asarray(t_train, np.float64)
    order = np.argsort(t_train)
    ts = t_train[order]
    ds = np.asarray(delta_train, np.float64)[order]
    es = np.asarray(eta_train, np.float64)[order]
    w = np.exp(es - es.max())
    s0 = np.cumsum(w[::-1])[::-1]
    # Breslow ties: risk set starts at first tied index
    first = np.searchsorted(ts, ts, side="left")
    # s0 was formed from stabilized w = exp(eta - max); true S0 = s0 * e^max,
    # so divide the increments by e^max to undo the stabilization.
    h_inc = ds / s0[first]
    h0 = np.cumsum(h_inc) * np.exp(-es.max())

    def h(query):
        idx = np.searchsorted(ts, query, side="right") - 1
        return np.where(idx >= 0, h0[np.clip(idx, 0, len(h0) - 1)], 0.0)

    return h


def ibs(t_train, delta_train, eta_train, t_test, delta_test, eta_test,
        n_grid: int = 100) -> float:
    """Integrated Brier Score (Graf et al. 1999) with IPCW weights.

    S(t|x) = exp(-H0(t) * exp(eta_x)) via the Breslow estimator on train.
    """
    h0 = breslow_baseline(t_train, delta_train, eta_train)
    g = km_censoring(t_train, delta_train)
    t_test = np.asarray(t_test, np.float64)
    delta_test = np.asarray(delta_test, np.float64)
    eta_test = np.asarray(eta_test, np.float64)
    lo, hi = np.quantile(t_test, 0.05), np.quantile(t_test, 0.95)
    grid = np.linspace(lo, hi, n_grid)
    scores = []
    for tt in grid:
        s = np.exp(-h0(tt) * np.exp(np.clip(eta_test, -30, 30)))
        died = (t_test <= tt) & (delta_test > 0)
        alive = t_test > tt
        bs = (np.where(died, (0.0 - s) ** 2 / g(np.minimum(t_test, tt)), 0.0)
              + np.where(alive, (1.0 - s) ** 2 / g(tt), 0.0))
        scores.append(bs.mean())
    return float(np.trapezoid(scores, grid) / (hi - lo))


def support_f1(beta_star: np.ndarray, beta_hat: np.ndarray,
               tol: float = 1e-8):
    """(precision, recall, f1) of support recovery (Appendix C.2)."""
    s_star = set(np.flatnonzero(np.abs(beta_star) > tol).tolist())
    s_hat = set(np.flatnonzero(np.abs(beta_hat) > tol).tolist())
    if not s_hat or not s_star:
        return 0.0, 0.0, 0.0
    inter = len(s_star & s_hat)
    prec = inter / len(s_hat)
    rec = inter / len(s_star)
    f1 = 0.0 if prec + rec == 0 else 2 * prec * rec / (prec + rec)
    return prec, rec, f1
