"""Synthetic survival data generators.

A numpy copy of the JAX package's ``data/synthetic.py``: the same spec and
seed give the same arrays.

``make_correlated_survival`` follows Appendix C of FastSurvival exactly:
  x_i ~ N(0, Sigma),  Sigma_jl = rho^|j-l|
  beta*_j = 1 if (j+1) mod (p/k) == 0 else 0         (k-sparse)
  t_i = (-log V_i / exp(x_i beta*))^s,  V_i ~ U(0,1), s = 0.1
  C_i ~ U(0,1);  delta_i = 1[t_i > C_i] ... observed t_i = min(t_i, C_i)

(The paper's Eq. 30 has the indicator as written; the conventional
definition is delta=1 when the event is observed, i.e. t_i <= C_i. We use
the conventional one and note the discrepancy — with the paper's literal
indicator, "events" would be exactly the censored samples, and none of the
reported metrics would be computable.)

``make_attrition_like`` mimics the Employee-Attrition preprocessing: a few
latent drivers, continuous columns binarized at many quantile thresholds
-> large blocks of highly correlated one-hot features.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    n: int = 1200
    p: int = 1200
    k: int = 15
    rho: float = 0.9
    s: float = 0.1
    censor_scale: float = 1.0
    seed: int = 0


def _ar1_sample(rng: np.random.Generator, n: int, p: int,
                rho: float) -> np.ndarray:
    """Sample N(0, Sigma) with Sigma_jl = rho^|j-l| in O(np) via the AR(1)
    representation x_j = rho x_{j-1} + sqrt(1-rho^2) eps_j (avoids the
    O(p^3) Cholesky of the paper's direct construction)."""
    eps = rng.standard_normal((n, p))
    x = np.empty((n, p), dtype=np.float64)
    x[:, 0] = eps[:, 0]
    c = np.sqrt(1.0 - rho * rho)
    for j in range(1, p):
        x[:, j] = rho * x[:, j - 1] + c * eps[:, j]
    return x


def make_correlated_survival(
    spec: SyntheticSpec,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (X, t, delta, beta_star) per Appendix C."""
    rng = np.random.default_rng(spec.seed)
    x = _ar1_sample(rng, spec.n, spec.p, spec.rho)
    beta_star = np.zeros(spec.p)
    stride = max(spec.p // spec.k, 1)
    idx = np.arange(1, spec.p + 1)
    beta_star[(idx % stride == 0)] = 1.0
    # cap at k nonzeros (paper's rule can produce a final partial stride)
    nz = np.flatnonzero(beta_star)[: spec.k]
    beta_star = np.zeros(spec.p)
    beta_star[nz] = 1.0

    risk = x @ beta_star
    risk = np.clip(risk, -30.0, 30.0)
    v = rng.uniform(1e-12, 1.0, size=spec.n)
    t_event = (-np.log(v) / np.exp(risk)) ** spec.s
    c = rng.uniform(0.0, spec.censor_scale, size=spec.n)
    delta = (t_event <= c).astype(np.float64)
    t_obs = np.minimum(t_event, c)
    return x.astype(np.float32), t_obs.astype(np.float32), \
        delta.astype(np.float32), beta_star.astype(np.float32)


def make_attrition_like(
    n: int = 2000, n_cont: int = 6, thresholds: int = 40, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Continuous drivers -> quantile-binarized one-hot blocks (highly
    correlated), Weibull-ish attrition times driven by two of the columns."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, n_cont))
    cols = []
    for j in range(n_cont):
        qs = np.quantile(z[:, j], np.linspace(0.05, 0.95, thresholds))
        cols.append((z[:, j][:, None] >= qs[None, :]).astype(np.float64))
    x = np.concatenate(cols, axis=1)
    risk = 1.2 * z[:, 0] - 0.8 * z[:, 1] + 0.5 * z[:, 2]
    risk = np.clip(risk, -30.0, 30.0)
    v = rng.uniform(1e-12, 1.0, size=n)
    t_event = (-np.log(v) / np.exp(risk)) ** 0.4
    c = rng.uniform(0.0, np.quantile(t_event, 0.8), size=n)
    delta = (t_event <= c).astype(np.float64)
    t_obs = np.minimum(t_event, c)
    return x.astype(np.float32), t_obs.astype(np.float32), \
        delta.astype(np.float32)


def make_tied_survival(n: int = 200, p: int = 8, n_times: int = 20,
                       seed: int = 0):
    """Small dataset with heavy ties (times drawn from a small grid) for
    exercising the Breslow tie handling in tests."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, p))
    beta = rng.standard_normal(p) * 0.5
    risk = np.clip(x @ beta, -30, 30)
    v = rng.uniform(1e-12, 1.0, size=n)
    t = (-np.log(v) / np.exp(risk)) ** 0.5
    t = np.ceil(t * n_times) / n_times  # grid -> ties
    delta = (rng.uniform(size=n) < 0.7).astype(np.float64)
    return x.astype(np.float32), t.astype(np.float32), delta.astype(np.float32)
