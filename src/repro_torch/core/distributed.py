"""Distributed FastSurvival: the paper's O(n) machinery with n sharded
over the ranks of a ``torch.distributed`` group.

The PyTorch port's counterpart of the JAX package's
``core/distributed.py``. Every rank passes the same whole inputs (the
global view, as the reference's ``shard_map`` takes a global array) and
computes on its own contiguous block of rows; results come back whole on
every rank. The scan structure distributes cleanly:
  * suffix sums: a local suffix scan per shard plus the sum of the shard
    totals to its right (one ``all_gather`` of scalars);
  * the all-coordinate GEMV form is a local matvec and one ``all_reduce``;
  * a CD sweep keeps eta resident and sharded; each coordinate moves only
    O(1) scalars between ranks.

Remainder shards: n need not divide the world size. Inputs are zero-padded
at the tail of the time axis (the youngest suffix positions, so suffix sums
over real rows are untouched) and a 0/1 mask zeroes the padded hazards;
``s0`` is clamped to 1 there so no 0/0 NaN can leak into a reduction.

The reference's ``model`` axis (p sharded over a second mesh axis) has
size 1 here: every rank holds all p columns of its rows. Local scans stay
plain ``torch.cumsum``, as the reference's stay ``lax.cumsum``. Like the
reference's, the risk-set statistics are the tie-free fast path
(``risk_start == arange``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from . import cox, surrogate

Tensor = torch.Tensor


def _world(group) -> Tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


def _pad0(v: Tensor, size: int) -> Tensor:
    """Zero-pad dim 0 up to a multiple of ``size``."""
    pad = (-v.shape[0]) % size
    if pad == 0:
        return v
    return torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])


def _mask_for(n: int, size: int, dtype, device) -> Tensor:
    """(n_padded,) 1.0 on real rows, 0.0 on the padded tail."""
    n_pad = n + ((-n) % size)
    return (torch.arange(n_pad, device=device) < n).to(dtype)


def _local(v: Tensor, size: int, rank: int) -> Tensor:
    """This rank's block of the padded rows."""
    m = v.shape[0] // size
    return v[rank * m:(rank + 1) * m]


def _gather_rows(v: Tensor, group) -> Tensor:
    """The ranks' row blocks, concatenated in rank order."""
    parts = [torch.empty_like(v) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, v.contiguous(), group=group)
    return torch.cat(parts)


def _totals(v: Tensor, group) -> Tensor:
    """(world, ...) every rank's column totals of ``v``."""
    return _gather_rows(v.sum(dim=0, keepdim=True), group)


def _suffix_local(xs: Tensor, group) -> Tensor:
    """Suffix sum of this rank's rows plus every later shard's total."""
    size, rank = _world(group)
    loc = torch.flip(torch.cumsum(torch.flip(xs, (0,)), 0), (0,))
    right = _totals(xs, group)[rank + 1:].sum(dim=0)
    return loc + right


def shard_revcumsum(x: Tensor, group=None) -> Tensor:
    """Suffix sum of a (n,) tensor with its rows sharded over ``group``:
    local suffix scan + the totals of the shards to the right. ``n`` need
    not divide the world size (zero tail-padding is exact for suffix
    sums)."""
    size, rank = _world(group)
    n = x.shape[0]
    out = _suffix_local(_local(_pad0(x, size), size, rank), group)
    return _gather_rows(out, group)[:n]


def shard_revcumsum_2d(x: Tensor, group=None) -> Tensor:
    """``shard_revcumsum`` of each column of a (n, p) tensor."""
    return shard_revcumsum(x, group)


def _risk_stats_local(eta_l: Tensor, delta_l: Tensor, mask_l: Tensor,
                      group):
    """Per-shard (w, s0_safe, a) on this rank's padded rows."""
    size, rank = _world(group)
    m = torch.amax(torch.where(mask_l > 0, eta_l, -torch.inf)).reshape(1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(eta_l - m) * mask_l
    s0 = _suffix_local(w, group)
    s0 = torch.where(mask_l > 0, s0, 1.0)   # pad rows: no 0/0 downstream
    d1 = delta_l / s0
    a = torch.cumsum(d1, 0) + _totals(d1, group)[:rank].sum()
    return w, s0, a


def _padded(data: cox.CoxData, eta: Tensor, group):
    size, rank = _world(group)
    mask = _mask_for(eta.shape[0], size, eta.dtype, eta.device)
    return (size, rank, _local(_pad0(eta, size), size, rank),
            _local(_pad0(data.delta, size), size, rank),
            _local(mask, size, rank))


def sharded_risk_stats(data: cox.CoxData, eta: Tensor, group=None):
    """(w, s0, a) of the tie-free risk sets, each (n,) whole on every
    rank, computed with the rows sharded over ``group``."""
    n = eta.shape[0]
    _, _, eta_l, d_l, mask_l = _padded(data, eta, group)
    w, s0, a = _risk_stats_local(eta_l, d_l, mask_l, group)
    return tuple(_gather_rows(v, group)[:n] for v in (w, s0, a))


def sharded_grad_hess_all(data: cox.CoxData, eta: Tensor, group=None
                          ) -> Tuple[Tensor, Tensor]:
    """All-coordinate (grad, diag hess), whole on every rank: each rank's
    rows give local GEMVs, summed by one ``all_reduce``."""
    size, rank, eta_l, d_l, mask_l = _padded(data, eta, group)
    x_l = _local(_pad0(data.x, size), size, rank)
    w, s0, a = _risk_stats_local(eta_l, d_l, mask_l, group)
    wa = w * a
    s1 = _suffix_local(w[:, None] * x_l, group)
    mean = s1 / s0[:, None]
    out = torch.stack([x_l.T @ (wa - d_l),
                       (x_l * x_l).T @ wa
                       - (d_l[:, None] * mean * mean).sum(dim=0)])
    dist.all_reduce(out, group=group)
    return out[0], out[1]


def fit_cd_sharded(data: cox.CoxData, l2c: Tensor, group=None,
                   lam1: float = 0.0, lam2: float = 0.0,
                   n_sweeps: int = 10) -> Tuple[Tensor, Tensor]:
    """Quadratic-surrogate CD with the rows sharded over ``group``. Per
    coordinate: one sharded suffix scan (O(n / ranks) and scalar
    collectives) and one local axpy on eta. Returns (beta, eta), whole on
    every rank."""
    size, rank = _world(group)
    x_l = _local(_pad0(data.x, size), size, rank)
    d_l = _local(_pad0(data.delta, size), size, rank)
    mask_l = _local(_mask_for(data.n, size, data.x.dtype, data.x.device),
                    size, rank)
    xT = x_l.T.contiguous()
    beta = torch.zeros(data.p, dtype=data.x.dtype, device=data.x.device)
    eta_l = torch.zeros(x_l.shape[0], dtype=data.x.dtype,
                        device=data.x.device)
    g = torch.empty(1, dtype=data.x.dtype, device=data.x.device)
    for _ in range(n_sweeps):
        for l in range(data.p):
            xl = xT[l]
            w, s0, a = _risk_stats_local(eta_l, d_l, mask_l, group)
            # grad_l = sum_k w_k a_k x_kl - sum delta x  (tie-free GEMV)
            g[0] = torch.sum((w * a - d_l) * xl)
            dist.all_reduce(g, group=group)
            step = surrogate.quad_l1_prox(g[0] + 2.0 * lam2 * beta[l],
                                          l2c[l] + 2.0 * lam2, beta[l], lam1)
            eta_l = eta_l + step * xl
            beta[l] = beta[l] + step
    return beta, _gather_rows(eta_l, group)[:data.n]
