"""k-fold cross-validation driver (the paper's evaluation protocol:
5-fold, mean +/- std of CIndex/IBS/loss per support size).

The PyTorch counterpart of the JAX package's ``survival/cv.py``: each
fold's training data is prepared on ``device`` for ``fit_fn``, and the
metrics are computed on the host."""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..core import cox
from . import metrics


def kfold_indices(n: int, k: int = 5, seed: int = 0):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return [(np.concatenate([perm[j::k] for j in range(k) if j != i]),
             perm[i::k]) for i in range(k)]


def cross_validate(x: np.ndarray, t: np.ndarray, delta: np.ndarray,
                   fit_fn: Callable, k: int = 5, seed: int = 0,
                   device="cuda") -> Dict[str, np.ndarray]:
    """fit_fn(CoxData_train on ``device``) -> beta (p,), a tensor or an
    array. Returns mean/std of CIndex and IBS over folds (the paper's
    Figs. 3/4 protocol). Raises without CUDA unless ``device`` is
    ``"cpu"``."""
    cis, ibss, losses = [], [], []
    for tr, te in kfold_indices(len(t), k, seed):
        data_tr = cox.prepare(x[tr], t[tr], delta[tr], device=device)
        beta = torch.as_tensor(fit_fn(data_tr)).cpu().numpy()
        eta_tr = x[tr] @ beta
        eta_te = x[te] @ beta
        cis.append(metrics.cindex(t[te], delta[te], eta_te))
        ibss.append(metrics.ibs(t[tr], delta[tr], eta_tr,
                                t[te], delta[te], eta_te))
        data_te = cox.prepare(x[te], t[te], delta[te], device=device)
        beta_te = torch.as_tensor(beta, dtype=data_te.x.dtype,
                                  device=data_te.device)
        losses.append(float(cox.loss_from_eta(data_te,
                                              data_te.x @ beta_te)))
    return {"cindex_mean": np.mean(cis), "cindex_std": np.std(cis),
            "ibs_mean": np.mean(ibss), "ibs_std": np.std(ibss),
            "loss_mean": np.mean(losses), "loss_std": np.std(losses)}
