"""The FastSurvival Appendix C cohort, made on the device from a seed.

    x_i ~ N(0, Sigma), Sigma_jl = rho^|j-l|   (the AR(1) form, O(n p))
    beta*_j = 1 if (j + 1) mod (p // k) == 0, the first k such j, else 0
    t_i = (-log V_i / exp(x_i beta*))^s,  V_i ~ U(1e-12, 1)
    C_i ~ U(0, censor_scale),  delta_i = 1[t_i <= C_i],  t_i <- min(t_i, C_i)

Times are rounded to float32, as a cohort stores them, which leaves ties
(about 1.4 thousand tied samples at n = 262,144), so the tie-group paths
of the program run. Columns are drawn as rows of x's transpose, each one
large call of the card's generator. Every seed draws a cohort of its own
at the same sizes.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Cohort(NamedTuple):
    x: torch.Tensor          # (n, p) float32
    t: torch.Tensor          # (n,) float32 observed times
    delta: torch.Tensor      # (n,) float32 event indicator
    beta_star: torch.Tensor  # (p,) float32, k ones


def beta_star(p: int, k: int, device="cpu") -> torch.Tensor:
    stride = max(p // k, 1)
    j = torch.arange(1, p + 1, device=device)
    nz = torch.nonzero(j % stride == 0).flatten()[:k]
    out = torch.zeros(p, dtype=torch.float32, device=device)
    out[nz] = 1.0
    return out


def make(cfg: dict, seed: int, device="cuda") -> Cohort:
    """The cohort of configuration ``cfg`` (keys n, p, k, rho, s,
    censor_scale) drawn from ``seed``: the same seed gives the same arrays
    on one kind of device."""
    n, p = int(cfg["n"]), int(cfg["p"])
    rho = float(cfg["rho"])
    gen = torch.Generator(device).manual_seed(seed)
    eps = torch.randn(p, n, generator=gen, dtype=torch.float32,
                      device=device)
    c = math.sqrt(1.0 - rho * rho)
    # x_j = rho x_{j-1} + sqrt(1 - rho^2) eps_j, in place over the rows
    for j in range(1, p):
        eps[j].mul_(c).add_(eps[j - 1], alpha=rho)
    x = eps.T.contiguous()
    del eps
    bs = beta_star(p, int(cfg["k"]), device)
    risk = torch.clamp((x @ bs).double(), -30.0, 30.0)
    u = torch.rand(2, n, generator=gen, dtype=torch.float64, device=device)
    v = 1e-12 + (1.0 - 1e-12) * u[0]
    t_event = (-torch.log(v) / torch.exp(risk)) ** float(cfg["s"])
    cens = float(cfg["censor_scale"]) * u[1]
    delta = (t_event <= cens).to(torch.float32)
    t = torch.minimum(t_event, cens).to(torch.float32)
    return Cohort(x=x, t=t, delta=delta, beta_star=bs)
