"""Stratified CPH (paper Conclusion, "CPH models with ... stratifications"):
each stratum keeps its own baseline hazard, i.e. risk sets never cross
strata. The loss is a sum of per-stratum partial likelihoods sharing beta.
Also Efron tie handling for the loss (the option the deep-survival head
uses, where gradients come from autodiff).

The PyTorch counterpart of the JAX package's ``core/stratified.py``. Rows
are sorted by (stratum, time) and risk_start/tie_end are found within each
stratum, after which the O(n) machinery (cox.py, solvers, beam search,
kernels) applies unchanged. Each function takes ``device`` and raises
without CUDA unless it is ``"cpu"``.
"""
from __future__ import annotations

import torch

from .. import device as _device
from . import cox

Tensor = torch.Tensor


def prepare_stratified(x, t, delta, strata, device="cuda"):
    """(CoxData whose risk sets are confined to each stratum, the sort
    order, the sorted strata), as the reference returns them."""
    dev = _device.resolve(device)
    x = torch.as_tensor(x, device=dev)
    t = torch.as_tensor(t, device=dev)
    delta = torch.as_tensor(delta, device=dev).to(x.dtype)
    strata = torch.as_tensor(strata, device=dev).to(torch.int32)
    # stratum, then time: two stable sorts, as a stable lexsort orders them
    by_time = torch.argsort(t, stable=True)
    order = by_time[torch.argsort(strata[by_time], stable=True)]
    ts, ss = t[order], strata[order]
    n = t.shape[0]
    idx = torch.arange(n, device=dev)
    # risk_start_i = first j in i's stratum with t_j == t_i; tie_end_i =
    # the last. O(n^2) is fine here: this is one-time preprocessing (the
    # O(n) path uses the sorted layout after)
    eq = (ss[:, None] == ss[None, :]) & torch.isclose(ts[:, None],
                                                      ts[None, :])
    risk_start = torch.where(eq, idx[None, :], n).min(dim=1).values
    tie_end = torch.where(eq, idx[None, :], -1).max(dim=1).values
    xs = x[order].contiguous()
    data = cox.CoxData(x=xs, xT=xs.T.contiguous(),
                       delta=delta[order].contiguous(),
                       risk_start=risk_start.to(torch.int32),
                       tie_end=tie_end.to(torch.int32))
    return data, order, ss


def stratified_loss(x, t, delta, strata, beta, device="cuda") -> Tensor:
    """Sum of per-stratum partial likelihoods (risk sets within stratum).

    ``cox.loss_from_eta``'s suffix sums run over the whole sorted array,
    which would leak mass across strata; here each risk set's suffix sum
    has the suffix total of the later strata taken off."""
    data, _, ss = prepare_stratified(x, t, delta, strata, device)
    beta = torch.as_tensor(beta, dtype=data.x.dtype, device=data.device)
    eta = data.x @ beta
    m = torch.max(eta)
    w = torch.exp(eta - m)
    rc = cox.revcumsum(w)
    n = eta.shape[0]
    ss_shift = torch.cat([ss[1:], torch.full((1,), -1, dtype=ss.dtype,
                                             device=ss.device)])
    stratum_end = ss != ss_shift                       # last row per stratum
    # the suffix of later strata at row i is rc at the first row after i's
    # stratum: the nearest stratum-end marker at or after i (a reverse
    # cummin; strata are contiguous, so it is i's own stratum's end + 1)
    idx = torch.arange(n, device=eta.device)
    marker = torch.where(stratum_end, idx + 1, n)
    next_start = torch.flip(torch.cummin(torch.flip(marker, (0,)), 0).values,
                            (0,))
    later = torch.where(next_start < n, rc[torch.clamp(next_start, max=n - 1)],
                        0.0)
    s0 = rc[data.risk_start.long()] - later
    log_s0 = torch.log(torch.clamp(s0, min=1e-30)) + m
    return torch.sum(data.delta * (log_s0 - eta))


def efron_loss(t, delta, eta, device="cuda") -> Tensor:
    """Efron tie-corrected negative log partial likelihood (for heavy-tie
    datasets; Breslow remains the CD default as in the paper).

    For a tie group with d events and event-hazard sum W_d, Efron replaces
    log(S0)^d by sum_{j=0..d-1} log(S0 - (j/d) W_d). O(n^2) pairwise tie
    masks, as in the reference."""
    dev = _device.resolve(device)
    eta = torch.as_tensor(eta, device=dev)
    t = torch.as_tensor(t, device=dev)
    delta = torch.as_tensor(delta, device=dev).to(eta.dtype)
    order = torch.argsort(t, stable=True)
    ts, dl, et = t[order], delta[order], eta[order]
    m = torch.max(et)
    w = torch.exp(et - m)
    rc = cox.revcumsum(w)
    s0 = rc[torch.searchsorted(ts, ts, side="left")]
    # per-sample rank within its tie group among events, and the group's
    # event hazard sum and event count
    n = ts.shape[0]
    eq = torch.isclose(ts[:, None], ts[None, :])
    idx = torch.arange(n, device=dev)
    before = eq & (idx[None, :] < idx[:, None])
    j_rank = (before * dl[None, :]).sum(dim=1)
    wd = (eq * (dl * w)[None, :]).sum(dim=1)
    d_cnt = torch.clamp((eq * dl[None, :]).sum(dim=1), min=1.0)
    s0_eff = s0 - (j_rank / d_cnt) * wd
    log_s0 = torch.log(torch.clamp(s0_eff, min=1e-30)) + m
    return torch.sum(dl * (log_s0 - et))
