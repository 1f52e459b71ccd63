"""Beam-search cardinality-constrained CPH (Section 3.5, "Constrained
Problem").

The PyTorch counterpart of the JAX package's ``core/beam.py``: support
expansion as in generalized OMP with a beam (FasterRisk/OKRidge style),
scored and finetuned with the monotone surrogate coordinate descent, the
paper's point (Newton-type inner solvers blow up).

The outer loop over support sizes runs on the host, as in the reference;
the inner work runs on ``data``'s device:

  * ``score_candidates``: for every feature not in the support, a few 1-D
    surrogate steps on that coordinate alone, then the *actual* loss
    decrease ("which coefficient, if optimized, results in the largest
    decrease"). Where the reference maps one column at a time over p, the
    port walks (n, block) panels of columns: each step is two suffix scans
    of a panel (``revcumsum`` on a card), the loss one more.
  * ``finetune_batch``: CD sweeps over the support columns of C
    candidate supports of one size at once, a coordinate descent over a
    candidate axis: each coordinate step of all C is one
    ``solvers.coord_step`` (on a card one ``cox_coord_step`` call: two
    launches, the surrogate step fused in, no host read), and
    the host reads the C losses and betas once. ``beam_search`` finetunes
    every unique candidate of a size in one such call, with the columns'
    L2 from its own constants; ``finetune`` is one candidate (C = 1), its
    L2 from ``lipschitz``.

``use_kernel=False`` takes ``core/cox.py``'s plain versions throughout,
one candidate at a time. Losses (a beam's, a finetuned support's) are
plain ``cox.loss_from_eta`` in both, so what the kernels launch is set by
the search alone: per scored beam ``(2 * steps + 1) *
len(column_blocks(...))`` ``revcumsum`` calls; per support size
``n_sweeps * size`` ``cox_coord_step`` calls over its C candidates, which
count ``C * size * n_sweeps`` ``cox_coord`` launches; one ``lipschitz``
for the search's L2. ``finetune`` alone (``omp_greedy``'s) launches
``|support| * n_sweeps`` ``cox_coord`` and one ``lipschitz``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .. import device as _device
from ..kernels import ops
from ..obs import trace
from . import cox, solvers, surrogate

Tensor = torch.Tensor

# bytes of one (n, block) float panel of score_candidates; about eight
# such panels are alive at once (the block's columns, E, W, W * X, two
# scans and their gathers): ~2.1 GB at n = 262,144 in float32
PANEL_BYTES = 1 << 28


@dataclasses.dataclass
class BeamResult:
    """Best model per support size: supports[k] has k+1 indices."""
    supports: List[np.ndarray]
    betas: List[np.ndarray]        # dense (p,) float32 coefficient vectors
    losses: List[float]            # unpenalized CPH loss of the best beam


def column_blocks(n: int, p: int, itemsize: int) -> List[slice]:
    """The column blocks ``score_candidates`` walks: (n, width) panels of
    at most PANEL_BYTES, width a multiple of 32 (so every full block takes
    ``revcumsum``'s one-launch panel layout) and at least 32."""
    width = max(32, PANEL_BYTES // (n * itemsize) // 32 * 32)
    return [slice(lo, min(lo + width, p)) for lo in range(0, p, width)]


def score_candidates(data: cox.CoxData, eta: Tensor, l2c: Tensor,
                     lam2: float, in_support, steps: int = 4,
                     use_kernel: bool = True):
    """Loss decrease achievable by optimizing each coordinate alone.

    From the beam's ``eta``, each column l takes ``steps`` quadratic-
    surrogate steps whose total is B_l, so its linear predictor is
    E[:, l] = eta + X[:, l] B_l; a step needs only the gradient
    g_l = sum_i delta_i (S1_il / S0_il - X_il), with S0 and S1 the suffix
    sums of W = exp(E - max_col E) and W X at each risk set's start.
    Returns (decrease (p,), step_total (p,)); support members
    (``in_support``, a (p,) bool mask) get -inf."""
    scan = ops.revcumsum if use_kernel else cox.revcumsum
    rs = data.risk_start.long()
    d = data.delta[:, None]
    base = cox.loss_from_eta(data, eta)
    curv = l2c + 2.0 * lam2
    dec = torch.empty_like(l2c)
    total = torch.empty_like(l2c)
    for cols in column_blocks(data.n, data.p, data.x.element_size()):
        x = data.x[:, cols].contiguous()
        b = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
        for _ in range(steps):
            e = eta[:, None] + x * b
            w = torch.exp(e - e.max(0).values)
            g = torch.sum(d * (scan(w * x)[rs] / scan(w)[rs] - x), 0)
            b = b + surrogate.quad_min(g + 2.0 * lam2 * b, curv[cols])
        e = eta[:, None] + x * b
        m = e.max(0).values
        loss = torch.sum(d * (torch.log(scan(torch.exp(e - m))[rs]) + m - e),
                         0)
        dec[cols] = base - (loss + lam2 * b * b)
        total[cols] = b
    in_support = torch.as_tensor(in_support, dtype=torch.bool,
                                 device=dec.device)
    return torch.where(in_support, -torch.inf, dec), total


def finetune(data: cox.CoxData, support_idx, support_mask, lam2: float,
             k_max: int, n_sweeps: int = 60, use_kernel: bool = True,
             groups: Optional[Tensor] = None):
    """CD (quadratic surrogate) from beta = 0 on the support's columns.

    ``support_idx`` (k_max,) and ``support_mask`` (k_max,) are host arrays
    as in the reference (padding arbitrary, masked out). A padded column
    there takes step 0, so only the real support is swept here; ``groups``
    (``ops.group_events``, made once per search) is made by the call when
    ``use_kernel`` and not given. With ``use_kernel`` this is
    ``finetune_batch`` of one candidate. The sweeps are one span,
    ``finetune.sweeps``, whose ``steps`` counts their coordinate steps.
    Returns (beta_s (k_max,), eta (n,), loss)."""
    pos = np.flatnonzero(np.asarray(support_mask) > 0)
    beta_s = torch.zeros(k_max, dtype=data.x.dtype, device=data.device)
    at = torch.as_tensor(pos, device=data.device)
    if use_kernel:
        betas, etas, losses = finetune_batch(
            data, np.asarray(support_idx)[pos][None], lam2, n_sweeps,
            groups)
        beta_s[at] = betas[0]
        return beta_s, etas[0], losses[0]
    cols = torch.as_tensor(np.asarray(support_idx)[pos].astype(np.int64),
                           device=data.device)
    xs = data.x[:, cols].contiguous()                  # (n, k)
    l2c, _ = cox.lipschitz_constants(cox.with_x(data, xs))
    curv = l2c + 2.0 * lam2
    rows = data.xT[cols]                               # (k, n)
    eta = torch.zeros(data.n, dtype=data.x.dtype, device=data.device)
    beta = torch.zeros(len(pos), dtype=data.x.dtype, device=data.device)
    with trace.span("finetune.sweeps", steps=len(pos) * n_sweeps,
                    candidates=1):
        for _ in range(n_sweeps):
            for j in range(len(pos)):
                g, _ = solvers.coord_grad_hess(data, eta, rows[j], None)
                step = surrogate.quad_min(g + 2.0 * lam2 * beta[j], curv[j])
                beta[j].add_(step)
                eta.addcmul_(rows[j], step)
    beta_s[at] = beta
    return beta_s, eta, cox.loss_from_eta(data, eta)


def finetune_batch(data: cox.CoxData, supports, lam2: float,
                   n_sweeps: int = 60, groups: Optional[Tensor] = None,
                   l2c: Optional[Tensor] = None):
    """``finetune`` of C candidate supports of one size at once, through
    the kernels (their plain versions on the CPU).

    ``supports`` is a (C, s) host array of column indices. Each candidate
    runs its own CD from beta = 0 over its columns in order, as
    ``finetune`` does, all C in step: a coordinate step of every candidate
    is one ``solvers.coord_step`` (its eta update folded into the next
    step's), and nothing is read back inside the sweeps. ``l2c`` is every
    column's L2 (the search's ``solvers.constants``); without it the call
    takes ``lipschitz`` over the candidates' columns. ``groups`` is made
    when not given. The sweeps are one span, ``finetune.sweeps``: ``steps``
    the candidate coordinate steps (C * s * n_sweeps), ``candidates`` C.
    Returns (betas (C, s), etas (C, n), losses (C,))."""
    cols = torch.as_tensor(np.asarray(supports, np.int64),
                           device=data.device)
    c, s = cols.shape
    if groups is None:
        groups = ops.group_events(data.delta, data.risk_start)
    if l2c is None:
        xs = data.x[:, cols.flatten()].contiguous()    # (n, C s)
        l2, _ = ops.lipschitz_constants(xs, data.delta, data.risk_start,
                                        groups)
        curv = l2.view(c, s) + 2.0 * lam2
    else:
        curv = l2c[cols] + 2.0 * lam2                  # (C, s)
    rows = data.xT[cols]                               # (C, s, n)
    eta = torch.zeros(c, data.n, dtype=data.x.dtype, device=data.device)
    beta = torch.zeros(c, s, dtype=data.x.dtype, device=data.device)
    step = torch.zeros(c, dtype=data.x.dtype, device=data.device)
    with trace.span("finetune.sweeps", steps=c * s * n_sweeps,
                    candidates=c):
        prev = None
        for _ in range(n_sweeps):
            for j in range(s):
                solvers.coord_step(data, eta, rows, j, prev, beta, curv,
                                   step, groups, lam2)
                prev = j
        if prev is not None:                           # the last update
            eta.addcmul_(rows[:, prev], step[:, None])
    losses = torch.stack([cox.loss_from_eta(data, e) for e in eta])
    return beta, eta, losses


def _padded(supp: tuple, k: int):
    idx = np.zeros(k, dtype=np.int32)
    msk = np.zeros(k, dtype=np.float32)
    idx[: len(supp)] = np.asarray(supp, np.int32)
    msk[: len(supp)] = 1.0
    return idx, msk


def beam_search(data: cox.CoxData, k: int, beam_width: int = 5,
                n_expand: int = 8, lam2: float = 1e-3,
                score_steps: int = 4, finetune_sweeps: int = 60,
                telemetry=None, use_kernel: bool = True,
                device="cuda") -> BeamResult:
    """Grow supports 1..k, keeping the ``beam_width`` best at each size.

    ``data`` must lie on ``device``, a card unless ``"cpu"``. Spans
    ``beam.search``, ``beam.size`` (candidate count and best loss),
    ``beam.score`` (beams scored) and ``beam.finetune`` (candidates) are
    recorded when tracing is on; an ``obs.TelemetryCallback`` also gets a
    tagged ``beam.size`` event per size (candidates, best loss, chosen
    support). The host reads each score vector, as the reference does, and
    each size's finetuned losses and betas at once."""
    _device.expect(data, device)
    l2c, _, groups = solvers.constants(data, use_kernel)
    p = data.p
    zero = torch.zeros(data.n, dtype=data.x.dtype, device=data.device)
    # beams: (loss, support tuple, eta)
    beams = [(float(cox.loss_from_eta(data, zero)), (), zero)]
    out = BeamResult(supports=[], betas=[], losses=[])

    with trace.span("beam.search", k=k, beam_width=beam_width, p=p):
        for size in range(1, k + 1):
            with trace.span("beam.size", size=size) as size_span:
                candidates = {}
                with trace.span("beam.score", n_beams=len(beams)):
                    for _, supp, eta_b in beams:
                        mask = np.zeros(p, dtype=bool)
                        mask[list(supp)] = True
                        dec, _ = score_candidates(
                            data, eta_b, l2c, lam2, mask, steps=score_steps,
                            use_kernel=use_kernel)
                        top = np.argsort(-dec.cpu().numpy())[:n_expand]
                        for l in top:
                            new_supp = tuple(sorted(supp + (int(l),)))
                            candidates.setdefault(new_supp, True)
                # finetune every unique candidate support: all at once
                # through the kernels, one at a time on the plain route
                supports = np.array(list(candidates), np.int64)
                with trace.span("beam.finetune",
                                n_candidates=len(candidates)):
                    if use_kernel:
                        betas, etas, losses = finetune_batch(
                            data, supports, lam2, finetune_sweeps, groups,
                            l2c)
                    else:
                        betas, etas, losses = map(torch.stack, zip(*(
                            finetune(data, supp, np.ones(size), lam2, size,
                                     n_sweeps=finetune_sweeps,
                                     use_kernel=False)
                            for supp in supports)))
                    scored = list(zip(losses.cpu().tolist(), candidates,
                                      etas, betas.cpu().numpy()))
                scored.sort(key=lambda s: s[0])
                beams = [(s[0], s[1], s[2]) for s in scored[:beam_width]]
                best = scored[0]
                beta_dense = np.zeros(p, dtype=np.float32)
                beta_dense[list(best[1])] = best[3]
                out.supports.append(np.asarray(best[1], np.int64))
                out.betas.append(beta_dense)
                out.losses.append(best[0])
                size_span.set(n_candidates=len(candidates),
                              best_loss=best[0])
                if telemetry is not None:
                    telemetry.record_event(
                        "beam.size", size=size,
                        n_candidates=len(candidates), best_loss=best[0],
                        support=list(map(int, best[1])))
    return out


def omp_greedy(data: cox.CoxData, k: int, lam2: float = 1e-3,
               finetune_sweeps: int = 60, use_kernel: bool = True,
               device="cuda") -> BeamResult:
    """Gradient-magnitude OMP baseline (what the paper improves upon):
    pick argmax |grad_l| each round (plain ``cox.grad_all``, read on the
    host), then finetune. Beam width 1, gradient scoring instead of
    loss-decrease scoring."""
    _device.expect(data, device)
    groups = (ops.group_events(data.delta, data.risk_start) if use_kernel
              else None)
    p = data.p
    supp: tuple = ()
    eta = torch.zeros(data.n, dtype=data.x.dtype, device=data.device)
    out = BeamResult(supports=[], betas=[], losses=[])
    for _ in range(k):
        g = np.array(cox.grad_all(data, eta).cpu())
        g[list(supp)] = 0.0
        supp = tuple(sorted(supp + (int(np.argmax(np.abs(g))),)))
        idx, msk = _padded(supp, k)
        beta_s, eta, loss = finetune(data, idx, msk, lam2, k,
                                     n_sweeps=finetune_sweeps,
                                     use_kernel=use_kernel, groups=groups)
        beta_dense = np.zeros(p, dtype=np.float32)
        beta_dense[idx[: len(supp)]] = beta_s.cpu().numpy()[: len(supp)]
        out.supports.append(np.asarray(supp, np.int64))
        out.betas.append(beta_dense)
        out.losses.append(float(loss))
    return out
