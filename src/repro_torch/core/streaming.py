"""Streaming (chunked) Cox partial-likelihood statistics.

The PyTorch counterpart of the JAX package's ``core/streaming.py``.

Every risk-set statistic is a suffix or prefix sum over the time-sorted
axis, and that survives chunking: a suffix sum over ``concat(chunks)`` is
each chunk's local suffix sum plus a carried total of the later chunks.
So the exact full-likelihood loss, gradient and diagonal Hessian can be
computed while only one (chunk_rows, p) block of the design matrix is
touched at a time, plus O(n) vectors (eta, s0).

Two estimands, both used by ``solvers.fit_stream``:

* **global**: the exact partial likelihood of the whole stream. Chunks
  arrive in ascending-time order with tie-free times, so every row's risk
  set is its own suffix; three passes over the source per evaluation
  (forward eta, reverse suffix statistics, forward prefix statistics).
* **chunk** (BigSurvSGD): each chunk is its own stratum with its own risk
  sets. One pass, no carry between chunks, no global order needed.

A source is anything indexable: ``len(source)`` and ``source[i] ->
Chunk``. A chunk's arrays may be tensors on any device or numpy arrays;
each is moved to the fit's device (that of ``beta``) when it is touched,
as JAX moves host arrays. ``as_chunks`` views an in-memory ``CoxData``.

``use_kernel=True`` (the default) sends the local suffix scans through
``ops.revcumsum`` and a chunk's all-coordinate derivatives through
``ops.cox_batch_grad_hess``: the CUDA kernels on a card, their plain
versions on the CPU. ``use_kernel=False`` is plain torch throughout. The
carries (``loc + carry``) are torch code on both paths.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch

from ..kernels import ops
from . import cox

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One time-contiguous block of a survival design matrix."""

    x: Any      # (m, p) features, time-sorted; a tensor or a numpy array
    delta: Any  # (m,)   event indicators

    @property
    def rows(self) -> int:
        return self.x.shape[0]


class ChunkView:
    """Chunked view over an in-memory ``CoxData`` (tests, small n)."""

    def __init__(self, data: cox.CoxData, chunk_rows: int):
        self._data = data
        self._rows = max(int(chunk_rows), 1)

    def __len__(self) -> int:
        return -(-self._data.n // self._rows)

    def __getitem__(self, i: int) -> Chunk:
        if not 0 <= i < len(self):
            raise IndexError(i)
        lo = i * self._rows
        hi = min(lo + self._rows, self._data.n)
        return Chunk(x=self._data.x[lo:hi], delta=self._data.delta[lo:hi])


def as_chunks(data: cox.CoxData, chunk_rows: int) -> ChunkView:
    """Chunked view of time-sorted data (global mode expects this order)."""
    return ChunkView(data, chunk_rows)


def _delta(chunk: Chunk, beta: Tensor) -> Tensor:
    """The chunk's delta on ``beta``'s device, in ``beta``'s type."""
    return torch.as_tensor(chunk.delta, device=beta.device).to(beta.dtype)


def _load(chunk: Chunk, beta: Tensor) -> Tuple[Tensor, Tensor]:
    """The chunk's (x, delta) as tensors on ``beta``'s device."""
    return torch.as_tensor(chunk.x, device=beta.device), _delta(chunk, beta)


def _local_revcumsum(v: Tensor, use_kernel: bool) -> Tensor:
    return ops.revcumsum(v) if use_kernel else cox.revcumsum(v, 0)


def chunked_revcumsum(segments: Sequence[Tensor],
                      use_kernel: bool = True) -> List[Tensor]:
    """Suffix sum of ``concat(segments)`` computed blockwise.

    Walks the segments youngest-first, a local suffix scan per segment
    plus the carried total of everything later: equal to the monolithic
    ``revcumsum`` for any chunk boundaries. Segments may be (m,) or
    (m, p); the carry is a scalar or a (p,) vector."""
    out: List[Optional[Tensor]] = [None] * len(segments)
    carry = None
    for i in reversed(range(len(segments))):
        v = segments[i]
        loc = _local_revcumsum(v, use_kernel)
        out[i] = loc if carry is None else loc + carry
        tot = v.sum(dim=0)
        carry = tot if carry is None else carry + tot
    return out  # type: ignore[return-value]


def _trivial_coxdata(x: Tensor, delta: Tensor) -> cox.CoxData:
    """Tie-free risk-set indexing for one stratum (risk_start == arange).
    ``xT`` is a transposed view, not a copy: nothing here walks it."""
    idx = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    return cox.CoxData(x=x, xT=x.T, delta=delta, risk_start=idx,
                       tie_end=idx)


# ---------------------------------------------------------------------------
# Exact global-likelihood statistics, chunk at a time
# ---------------------------------------------------------------------------

def _forward_eta(source, beta: Tensor) -> Tuple[List[Tensor], Tensor]:
    """Pass 1: per-chunk linear predictors and the global stabilizer max."""
    etas = []
    m = None
    for i in range(len(source)):
        e = torch.as_tensor(source[i].x, device=beta.device) @ beta
        etas.append(e)
        em = torch.max(e)
        m = em if m is None else torch.maximum(m, em)
    return etas, m.detach()


def streaming_grad_hess(source, beta: Tensor, use_kernel: bool = True
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Exact full-stream (grad, hess_diag, loss) at ``beta``.

    Equals ``cox.grad_hess_all`` / ``cox.loss_from_eta`` on the
    concatenated tie-free data, touching the (n, p) matrix one chunk at a
    time:

    * reverse pass: the suffix statistics s0 (scalar carry) and
      s1 = suffix(w x) ((p,) carry) feed the Hessian's mean term and the
      loss, both pure suffix quantities;
    * forward pass: the prefix statistic A = cumsum(delta / s0) (scalar
      carry) feeds the swapped-order GEMV gradient and Hessian term1.
    """
    k = len(source)
    etas, m = _forward_eta(source, beta)
    p = beta.shape[0]
    dtype, dev = etas[0].dtype, beta.device

    # pass 2 (reverse): s0 per row, Hessian term2, loss
    carry0 = torch.zeros((), dtype=dtype, device=dev)
    carry1 = torch.zeros((p,), dtype=dtype, device=dev)
    term2 = torch.zeros((p,), dtype=dtype, device=dev)
    loss = torch.zeros((), dtype=dtype, device=dev)
    s0s: List[Optional[Tensor]] = [None] * k
    for i in reversed(range(k)):
        x, delta = _load(source[i], beta)
        e = etas[i]
        w = torch.exp(e - m)
        wx = w[:, None] * x
        s0 = _local_revcumsum(w, use_kernel) + carry0
        s1 = _local_revcumsum(wx, use_kernel) + carry1
        mean = s1 / s0[:, None]
        term2 = term2 + (delta[:, None] * mean * mean).sum(dim=0)
        loss = loss + torch.sum(delta * (torch.log(s0) + m - e))
        s0s[i] = s0
        carry0 = carry0 + w.sum()
        carry1 = carry1 + wx.sum(dim=0)

    # pass 3 (forward): prefix A, gradient and Hessian term1
    carry_a = torch.zeros((), dtype=dtype, device=dev)
    grad = torch.zeros((p,), dtype=dtype, device=dev)
    term1 = torch.zeros((p,), dtype=dtype, device=dev)
    for i in range(k):
        x, delta = _load(source[i], beta)
        w = torch.exp(etas[i] - m)
        d1 = delta / s0s[i]
        a = torch.cumsum(d1, 0) + carry_a
        wa = w * a
        grad = grad + x.T @ (wa - delta)
        term1 = term1 + (x * x).T @ wa
        carry_a = carry_a + d1.sum()
    return grad, term1 - term2, loss


def streaming_loss(source, beta: Tensor, use_kernel: bool = True) -> Tensor:
    """Exact full-stream negative log partial likelihood (two passes)."""
    etas, m = _forward_eta(source, beta)
    carry0 = torch.zeros((), dtype=etas[0].dtype, device=beta.device)
    loss = torch.zeros((), dtype=etas[0].dtype, device=beta.device)
    for i in reversed(range(len(source))):
        delta = _delta(source[i], beta)
        w = torch.exp(etas[i] - m)
        s0 = _local_revcumsum(w, use_kernel) + carry0
        loss = loss + torch.sum(delta * (torch.log(s0) + m - etas[i]))
        carry0 = carry0 + w.sum()
    return loss


# ---------------------------------------------------------------------------
# Chunk-as-stratum (BigSurvSGD) statistics
# ---------------------------------------------------------------------------

def stratum_grad_hess(chunk: Chunk, beta: Tensor, use_kernel: bool = True
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """(grad, hess_diag, loss) of one chunk treated as its own stratum."""
    x, delta = _load(chunk, beta)
    eta = x @ beta
    data = _trivial_coxdata(x, delta)
    if use_kernel:
        g, h = ops.cox_batch_grad_hess(eta, x, delta)
    else:
        g, h = cox.grad_hess_all(data, eta)
    return g, h, cox.loss_from_eta(data, eta)


def stratified_grad_hess(source, beta: Tensor, use_kernel: bool = True
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """Summed per-stratum (grad, hess_diag, loss) over the chunk source."""
    p = beta.shape[0]
    grad = torch.zeros((p,), dtype=beta.dtype, device=beta.device)
    hess = torch.zeros((p,), dtype=beta.dtype, device=beta.device)
    loss = torch.zeros((), dtype=beta.dtype, device=beta.device)
    for i in range(len(source)):
        g, h, f = stratum_grad_hess(source[i], beta, use_kernel)
        grad, hess, loss = grad + g, hess + h, loss + f
    return grad, hess, loss


def stratified_loss(source, beta: Tensor) -> Tensor:
    """Summed per-stratum loss (one pass, no carry)."""
    loss = torch.zeros((), dtype=beta.dtype, device=beta.device)
    for i in range(len(source)):
        x, delta = _load(source[i], beta)
        loss = loss + cox.loss_from_eta(_trivial_coxdata(x, delta), x @ beta)
    return loss
