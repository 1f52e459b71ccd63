"""Nonconvex separable penalties for the surrogate CD framework:
SCAD (Fan & Li 2001) and MCP (Zhang 2010), the extensions §3.5 of the
paper names next to LASSO/ElasticNet.

The PyTorch counterpart of the JAX package's ``core/penalties.py``. For
the quadratic surrogate  a·D + ½ b·D² + pen(|c + D|)  the coordinate
update is the penalty's scalar proximal operator at the Newton point
z = c − a/b with weight w = 1/b. Both closed forms are branchless
(``torch.where``), so a sweep on a card never waits on the host; since
``torch.where`` evaluates every branch, the curvature b is clamped at
1e-12 and the nonconvex branch's denominator at 1e-3, as in the
reference, so no branch divides by zero.

prox derivations (threshold lam, curvature w = 1/b):
  MCP  (gamma > 1):  |z| <= lam w          -> 0
                     |z| <= gamma lam      -> soft(z, lam w)/(1 - w/gamma)
                     else                  -> z
  SCAD (gamma > 2):  |z| <= lam (1 + w)    -> soft(z, lam w)
                     |z| <= gamma lam      -> soft(z, gamma lam w/(gamma-1))
                                              / (1 - w/(gamma-1))
                     else                  -> z
"""
from __future__ import annotations

import torch

from .surrogate import _tensors

Tensor = torch.Tensor
_EPS = 1e-12


def _soft(z: Tensor, t) -> Tensor:
    return torch.sign(z) * torch.clamp(torch.abs(z) - t, min=0.0)


def mcp_value(beta: Tensor, lam: float, gamma: float = 3.0) -> Tensor:
    a = torch.abs(beta)
    quad = lam * a - a * a / (2.0 * gamma)
    flat = 0.5 * gamma * lam * lam
    return torch.sum(torch.where(a <= gamma * lam, quad, flat))


def scad_value(beta: Tensor, lam: float, gamma: float = 3.7) -> Tensor:
    a = torch.abs(beta)
    lin = lam * a
    quad = (2.0 * gamma * lam * a - a * a - lam * lam) / (2.0 * (gamma - 1.0))
    flat = lam * lam * (gamma + 1.0) / 2.0
    return torch.sum(torch.where(a <= lam, lin,
                                 torch.where(a <= gamma * lam, quad, flat)))


def mcp_prox(a, b, c, lam, gamma: float = 3.0) -> Tensor:
    """argmin_D a D + 1/2 b D^2 + MCP(|c + D|; lam, gamma); returns D."""
    a, b, c, lam = _tensors(a, b, c, lam)
    b = torch.clamp(b, min=_EPS)
    w = 1.0 / b
    z = c - a * w
    az = torch.abs(z)
    denom = torch.clamp(1.0 - w / gamma, min=1e-3)  # surrogate curvature
    inner = _soft(z, lam * w) / denom
    new = torch.where(az <= gamma * lam, inner, z)
    return new - c


def scad_prox(a, b, c, lam, gamma: float = 3.7) -> Tensor:
    """argmin_D a D + 1/2 b D^2 + SCAD(|c + D|; lam, gamma); returns D."""
    a, b, c, lam = _tensors(a, b, c, lam)
    b = torch.clamp(b, min=_EPS)
    w = 1.0 / b
    z = c - a * w
    az = torch.abs(z)
    r1 = _soft(z, lam * w)
    denom = torch.clamp(1.0 - w / (gamma - 1.0), min=1e-3)
    r2 = _soft(z, gamma * lam * w / (gamma - 1.0)) / denom
    new = torch.where(az <= lam * (1.0 + w), r1,
                      torch.where(az <= gamma * lam, r2, z))
    return new - c


PROX = {"mcp": mcp_prox, "scad": scad_prox}
VALUE = {"mcp": mcp_value, "scad": scad_value}
