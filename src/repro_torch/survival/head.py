"""Deep-survival head: the paper's CPH objective on any backbone in the
pool (DeepSurv-style).

The PyTorch port's counterpart of the JAX package's ``survival/head.py``.
The batch is the risk-set universe: risk scores eta_i come from the pooled
final hidden state, the batch is sorted by observed time inside the step,
and the loss is the exact Breslow negative log partial likelihood from
``core/cox.py``, so the gradient into the backbone is the eta-space
gradient (w*A - delta) the paper analyzes. The loss is built from plain
torch ops, so ``torch.autograd`` takes that gradient through it
(``trainer.make_train_step(objective="cox")``).

``sparse_refit`` applies the paper's beam-search CD on frozen pooled
features to produce an interpretable sparse linear head.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core import beam, cox
from ..models.model import Model
from ..models.pspec import whole

Tensor = torch.Tensor


def init_cox_head(gen: torch.Generator, d_model: int,
                  device="cuda") -> nn.ParameterDict:
    """w ~ 0.01 N(0, 1) of shape (d_model, 1), b = 0, in float32."""
    w = torch.randn(d_model, 1, generator=gen, dtype=torch.float32,
                    device=device)
    return nn.ParameterDict({
        "w": nn.Parameter(w * 0.01),
        "b": nn.Parameter(torch.zeros((), dtype=torch.float32,
                                      device=device))})


def cox_partial_likelihood(eta: Tensor, time: Tensor, event: Tensor) -> Tensor:
    """Exact CPH loss of a batch, sorted on the fly (Breslow ties), over the
    batch's events."""
    order = torch.argsort(time, stable=True)
    ts = time[order].contiguous()
    risk_start = torch.searchsorted(ts, ts, side="left").to(torch.int32)
    tie_end = (torch.searchsorted(ts, ts, side="right") - 1).to(torch.int32)
    x = torch.zeros(time.shape[0], 0, dtype=eta.dtype, device=eta.device)
    data = cox.CoxData(x=x, xT=x.T.contiguous(),
                       delta=event[order].to(eta.dtype),
                       risk_start=risk_start, tie_end=tie_end)
    return cox.loss_from_eta(data, eta[order]) \
        / torch.clamp_min(torch.sum(event), 1.0)


def cox_loss(model: Model, batch):
    """Survival objective of a batch for
    ``trainer.make_train_step(objective="cox")``: the partial likelihood of
    the model's risk scores (each layer rematerialized in the backward
    pass, as the reference's default), plus 0.01 x aux."""
    eta, aux = model.risk_scores(batch)
    # the risk set spans the whole batch, whichever rank holds its rows
    loss = cox_partial_likelihood(whole(eta.float()), whole(batch["time"]),
                                  whole(batch["event"]))
    return loss + 0.01 * aux, {"cox_nll": loss, "aux": aux}


def pooled_features(model: Model, batch) -> Tensor:
    """The final hidden state mean-pooled over every position, float32."""
    hidden, _ = model.hidden_states(batch, remat=False)
    return hidden.mean(dim=1).float()


def sparse_refit(features: np.ndarray, time: np.ndarray, event: np.ndarray,
                 k: int, beam_width: int = 4, device="cuda"):
    """Beam-search L0-constrained CPH on frozen backbone features, on
    ``device`` (a card unless ``"cpu"``) — the paper's variable selection
    producing an interpretable sparse head."""
    data = cox.prepare(features, time, event, device=device)
    return beam.beam_search(data, k=k, beam_width=beam_width, device=device)
