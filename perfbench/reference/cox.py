"""Plain PyTorch reference of the paper's Cox pipeline: the time sort and
Breslow risk sets, the loss, the Theorem 3.4 constant L2, and beam search
over supports with candidate scoring and coordinate-descent finetuning.

It imports nothing of the program and takes nothing the program made:
every derived quantity (the sort, risk-set starts, tie groups, constants)
is worked out here again from the raw (x, t, delta). It computes in the
dtype it is given (float64 for the reference, bfloat16 for the control);
the feature matrix is kept transposed, (p, n), so each column is a
contiguous row and each suffix sum runs along the last dimension.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple

import torch

Tensor = torch.Tensor
_EPS = 1e-12


class Sorted(NamedTuple):
    xT: Tensor          # (p, n) features, columns as rows, time-sorted
    delta: Tensor       # (n,)
    rs: Tensor          # (n,) int64: first index of each sample's tie group
    tie_end: Tensor     # (n,) int64: last index of its tie group


def prepare(x: Tensor, t: Tensor, delta: Tensor, dtype) -> Sorted:
    """Sort by time (stable) and index the Breslow tie groups."""
    order = torch.argsort(t, stable=True)
    ts = t[order]
    rs = torch.searchsorted(ts, ts, side="left")
    te = torch.searchsorted(ts, ts, side="right") - 1
    xT = x[order].T.to(dtype).contiguous()
    return Sorted(xT=xT, delta=delta[order].to(dtype), rs=rs, tie_end=te)


def rcs(v: Tensor) -> Tensor:
    """Suffix sums along the last dimension."""
    return torch.flip(torch.cumsum(torch.flip(v, (-1,)), -1), (-1,))


def loss(d: Sorted, eta: Tensor) -> Tensor:
    """Negative log partial likelihood (Breslow) of each row of ``eta``
    ((n,) or (m, n))."""
    m = eta.max(-1, keepdim=True).values
    s0 = rcs(torch.exp(eta - m))[..., d.rs]
    return torch.sum(d.delta * (torch.log(s0) + m - eta), -1)


def lipschitz_l2(d: Sorted, rows: Tensor = None, block: int = 64) -> Tensor:
    """L2_l = 1/4 sum_i delta_i (max_{k in R_i} x_kl - min_{k in R_i})^2 of
    the columns ``rows`` (all by default)."""
    idx = (torch.arange(d.xT.shape[0], device=d.xT.device) if rows is None
           else rows)
    out = []
    for lo in range(0, len(idx), block):
        xb = d.xT[idx[lo:lo + block]]
        f = torch.flip(xb, (-1,))
        hi = torch.flip(torch.cummax(f, -1).values, (-1,))[:, d.rs]
        lo_ = torch.flip(torch.cummin(f, -1).values, (-1,))[:, d.rs]
        r = hi - lo_
        out.append(0.25 * torch.sum(d.delta * r * r, -1))
    return torch.cat(out)


def _grad_rows(d: Sorted, eta: Tensor, x: Tensor) -> Tensor:
    """d loss / d beta of each row's own column: ``eta`` (m, n) or (n,),
    ``x`` (m, n); the risk sets' sums read at each tie group's start."""
    w = torch.exp(eta - eta.max(-1, keepdim=True).values)
    s0 = rcs(w)[..., d.rs]
    s1 = rcs(w * x)[..., d.rs]
    return torch.sum(d.delta * (s1 / s0 - x), -1)


def score(d: Sorted, eta: Tensor, l2: Tensor, lam2: float,
          in_support: Sequence[int], steps: int, block: int = 128) -> Tensor:
    """Loss decrease of each column optimized alone from ``eta``: ``steps``
    quadratic-surrogate steps on the column, then the loss with its l2
    term; -inf on the support."""
    p = d.xT.shape[0]
    base = loss(d, eta)
    curv = l2 + 2.0 * lam2
    dec = torch.empty(p, dtype=eta.dtype, device=eta.device)
    for lo in range(0, p, block):
        x = d.xT[lo:lo + block]
        b = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for _ in range(steps):
            g = _grad_rows(d, eta + x * b[:, None], x)
            b = b - (g + 2.0 * lam2 * b) / torch.clamp(curv[lo:lo + block],
                                                       min=_EPS)
        dec[lo:lo + block] = base - (loss(d, eta + x * b[:, None])
                                     + lam2 * b * b)
    if len(in_support):
        dec[torch.as_tensor(list(in_support), device=dec.device)] = -math.inf
    return dec


def finetune(d: Sorted, supports: List[Tuple[int, ...]], l2: Tensor,
             lam2: float, sweeps: int):
    """CD on each support's columns from beta = 0, all supports (of one
    size) at once; returns (betas (C, s), etas (C, n), losses (C,))."""
    cols = torch.as_tensor(supports, device=d.xT.device)        # (C, s)
    xs = d.xT[cols]                                             # (C, s, n)
    curv = l2[cols] + 2.0 * lam2
    c, s = cols.shape
    beta = torch.zeros(c, s, dtype=xs.dtype, device=xs.device)
    eta = torch.zeros(c, d.xT.shape[1], dtype=xs.dtype, device=xs.device)
    for _ in range(sweeps):
        for j in range(s):
            x = xs[:, j]
            g = _grad_rows(d, eta, x)
            step = -(g + 2.0 * lam2 * beta[:, j]) / torch.clamp(curv[:, j],
                                                                min=_EPS)
            beta[:, j] = beta[:, j] + step
            eta = eta + x * step[:, None]
    return beta, eta, loss(d, eta)


def beam_search(d: Sorted, k: int, beam_width: int, n_expand: int,
                lam2: float, score_steps: int, finetune_sweeps: int):
    """Supports of sizes 1..k, keeping the ``beam_width`` best of each
    size by finetuned loss; returns (supports, betas (p,) each, losses),
    the best of each size."""
    p, n = d.xT.shape
    l2 = lipschitz_l2(d)
    zero = torch.zeros(n, dtype=d.xT.dtype, device=d.xT.device)
    beams = [((), zero)]
    supports, betas, losses = [], [], []
    for _ in range(k):
        cands = {}
        for supp, eta in beams:
            dec = score(d, eta, l2, lam2, supp, score_steps)
            top = torch.argsort(-dec.double(), stable=True)[:n_expand]
            for l in top.tolist():
                cands.setdefault(tuple(sorted(supp + (int(l),))), True)
        order = list(cands)
        bet, etas, ls = finetune(d, order, l2, lam2, finetune_sweeps)
        ls_host = ls.double().cpu().tolist()
        rank = sorted(range(len(order)), key=lambda i: ls_host[i])
        beams = [(order[i], etas[i]) for i in rank[:beam_width]]
        best = rank[0]
        dense = torch.zeros(p, dtype=torch.float64)
        dense[list(order[best])] = bet[best].double().cpu()
        supports.append(order[best])
        betas.append(dense)
        losses.append(ls_host[best])
    return supports, betas, losses
