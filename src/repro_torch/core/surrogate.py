"""Quadratic and cubic surrogate minimizers and their l1-regularized
analytic solutions (Section 3.4/3.5 and Appendix A.4/A.5 of FastSurvival).

The PyTorch counterpart of the JAX package's ``core/surrogate.py``. Every
function is a branchless scalar map on 0-d tensors (or Python floats), so
a coordinate-descent sweep on a card never waits on the host for one.

Notation follows the paper:
  quadratic surrogate at x:  g(D) = f(x) + a D + 1/2 b D^2,   a=f'(x), b=L2
  cubic surrogate at x:      h(D) = f(x) + a D + 1/2 b D^2 + 1/6 c |D|^3,
                             a=f'(x), b=f''(x), c=L3
Ridge (lam2 ||.||^2) is absorbed by a += 2 lam2 x, b += 2 lam2 (footnote 2).
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import torch

Tensor = torch.Tensor
_EPS = 1e-12


def _tensors(*vals) -> List[Tensor]:
    """Every value as a tensor of the widest float type among the tensor
    arguments (Python floats take it, as JAX's weak types do). A Python
    float becomes a 0-d CPU tensor, which PyTorch lets any device's
    tensors combine with: making it on a card would copy from the host and
    wait for the stream, once per coordinate."""
    ts = [v for v in vals if isinstance(v, Tensor)]
    dtype = (functools.reduce(torch.promote_types, (t.dtype for t in ts))
             if ts else torch.get_default_dtype())
    return [v if isinstance(v, Tensor) else torch.tensor(v, dtype=dtype)
            for v in vals]


def quad_min(a, b) -> Tensor:
    """argmin a*D + 1/2 b D^2  =  -a/b (Eq. 17)."""
    a, b = _tensors(a, b)
    return -a / torch.clamp(b, min=_EPS)


def cubic_min(a, b, c) -> Tensor:
    """argmin a*D + 1/2 b D^2 + 1/6 c |D|^3 (Eq. 18), written without the
    catastrophic cancellation: -2|a| sgn(a) / (b + sqrt(b^2 + 2c|a|))."""
    a, b, c = _tensors(a, b, c)
    c = torch.clamp(c, min=0.0)
    disc = torch.sqrt(b * b + 2.0 * c * torch.abs(a))
    step = -2.0 * torch.abs(a) / torch.clamp(b + disc, min=_EPS)
    return torch.sign(a) * step


def quad_l1_prox(a, b, c, lam1) -> Tensor:
    """argmin a*D + 1/2 b D^2 + lam1 |c + D|  (Eq. 20); c = current coord.

    Equivalent to soft-thresholding the Newton point of the surrogate.
    """
    a, b, c, lam1 = _tensors(a, b, c, lam1)
    b = torch.clamp(b, min=_EPS)
    u = b * c - a
    z = torch.sign(u) * torch.clamp(torch.abs(u) - lam1, min=0.0) / b
    return z - c


def _cubic_piece_value(delta: Tensor, a: Tensor, b: Tensor, c: Tensor,
                       lam1: Tensor, d: Tensor) -> Tensor:
    """Objective a D + 1/2 b D^2 + 1/6 c |D|^3 + lam1 |d + D|."""
    return (a * delta + 0.5 * b * delta * delta
            + (c / 6.0) * torch.abs(delta) ** 3 + lam1 * torch.abs(d + delta))


@functools.lru_cache(maxsize=None)
def _piece_signs(dtype: torch.dtype, device: torch.device
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """(s3, s1, sgn) for the 8 stationary candidates, in the order the JAX
    package enumerates them (s3 outer, then s1, then the root's sign).
    Cached so a sweep on a card makes no host-to-device copy."""
    s3 = torch.tensor([1.0] * 4 + [-1.0] * 4, dtype=dtype, device=device)
    s1 = torch.tensor([1.0, 1.0, -1.0, -1.0] * 2, dtype=dtype, device=device)
    sgn = torch.tensor([1.0, -1.0] * 4, dtype=dtype, device=device)
    return s3, s1, sgn


def cubic_l1_prox(a, b, c, d, lam1) -> Tensor:
    """argmin_D a D + 1/2 b D^2 + 1/6 c |D|^3 + lam1 |d + D| (Eq. 21/22).

    Candidate enumeration: the objective is piecewise smooth with kinks at
    D = 0 and D = -d; on each smooth piece the stationary point solves a
    quadratic. Every stationary candidate valid on its piece, plus both
    kinks, is scored and the argmin taken — branchless, exactly equivalent
    to the paper's Eq. (22) case analysis but immune to sgn(0) edge cases.
    The 8 stationary candidates are formed as one vector.
    """
    a, b, c, d, lam1 = _tensors(a, b, c, d, lam1)
    c = torch.clamp(c, min=0.0)
    s3, s1, sgn = _piece_signs(a.dtype, a.device)
    # derivative on piece (s3 = sign D, s1 = sign(d + D)):
    #   a + b D + s3 c/2 D^2 + s1 lam1 = 0
    aa = 0.5 * s3 * c
    bb = b
    cc = a + s1 * lam1
    disc = bb * bb - 4.0 * aa * cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    root_q = (-bb + sgn * sq) / torch.where(
        torch.abs(2.0 * aa) < _EPS, torch.inf, 2.0 * aa)
    root_l = -cc / torch.where(torch.abs(bb) < _EPS, torch.inf, bb)
    root = torch.where(torch.abs(aa) < _EPS, root_l, root_q)
    ok = ((disc >= 0.0) & (root * s3 >= 0.0) & ((d + root) * s1 >= 0.0)
          & torch.isfinite(root))
    cand = torch.cat([torch.where(ok, root, 0.0),
                      torch.zeros_like(a).reshape(1), (-d).reshape(1)])
    vals = _cubic_piece_value(cand, a, b, c, lam1, d)
    return cand.gather(0, torch.argmin(vals).reshape(1)).reshape(())


def cubic_l1_prox_paper(a, b, c, d, lam1) -> Tensor:
    """Eq. (22) unified formula, with the appendix-correct signs.

    The unified formula printed as Eq. (22) has ``(b + sqrt(...))/c`` in
    its second and third branches; the case-by-case derivation in Appendix
    A.5 yields ``(b - sqrt(...))/c``, which this follows (as the JAX
    package does). Valid for d != 0; d == 0 falls back to the one-sided
    analysis (threshold at |a| <= lam1).
    """
    a, b, c, d, lam1 = _tensors(a, b, c, d, lam1)
    c = torch.clamp(c, min=_EPS)
    s = torch.sign(d)
    cond1 = s * a + lam1 <= 0.0
    cond2 = s * (a - b * d) - 0.5 * c * d * d > lam1
    cond3 = s * (a - b * d) - 0.5 * c * d * d < -lam1
    r1 = s * (-b + torch.sqrt(torch.clamp(b * b - 2.0 * c * (s * a + lam1),
                                          min=0.0))) / c
    r2 = s * (b - torch.sqrt(torch.clamp(b * b + 2.0 * c * (s * a - lam1),
                                         min=0.0))) / c
    r3 = s * (b - torch.sqrt(torch.clamp(b * b + 2.0 * c * (s * a + lam1),
                                         min=0.0))) / c
    out = torch.where(cond1, r1,
                      torch.where(cond2, r2, torch.where(cond3, r3, -d)))
    a0 = torch.abs(a) - lam1
    # den is 0 only when b == 0 and c * a0 underflows (a0 subnormal): the
    # exact step is then below the float grid's resolution, so take 0.
    den = b + torch.sqrt(b * b + 2.0 * c * a0)
    zero_step = torch.where(
        (a0 <= 0.0) | (den <= 0.0), 0.0,
        -torch.sign(a) * 2.0 * a0 / den)
    return torch.where(d == 0.0, zero_step, out)


def quad_decrease(a, b) -> Tensor:
    """Guaranteed decrease of the quadratic surrogate: a^2 / (2b)."""
    a, b = _tensors(a, b)
    return 0.5 * a * a / torch.clamp(b, min=_EPS)
