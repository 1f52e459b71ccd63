"""Carry the JAX package's state across to the port.

Both packages speak numpy at their edges, so state moves as numpy arrays:
data into a time-sorted ``CoxData``, a reference artifact's arrays into the
port's ``SurvivalModel``, and coefficients onto a device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.cox import CoxData, prepare
from .serving.artifacts import ARRAY_FIELDS, SurvivalModel


def cox_data_from_numpy(x: np.ndarray, t: np.ndarray, delta: np.ndarray,
                        device="cuda") -> CoxData:
    """Time-sorted ``CoxData`` from numpy arrays, keeping ``x``'s float type
    (float64 stays float64, as the reference does under x64)."""
    return prepare(torch.from_numpy(np.ascontiguousarray(x)),
                   torch.from_numpy(np.ascontiguousarray(t)),
                   torch.from_numpy(np.ascontiguousarray(delta)),
                   device=device)


def model_from_reference(arrays: Dict[str, np.ndarray],
                         ties: str) -> SurvivalModel:
    """The port's ``SurvivalModel`` from the reference's ``beta``,
    ``time_grid``, ``base_cumhaz`` and, where present, ``support``,
    ``beta_support`` and ``strata_labels`` arrays, unchanged."""
    unknown = set(arrays) - set(ARRAY_FIELDS)
    if unknown:
        raise ValueError(f"unknown artifact arrays: {sorted(unknown)}")
    return SurvivalModel(ties=ties, **{
        name: np.asarray(arrays[name]) for name in ARRAY_FIELDS
        if arrays.get(name) is not None})


def beta_to_device(beta: np.ndarray, device="cuda") -> torch.Tensor:
    """Coefficients as a tensor on ``device``, in their own float type."""
    return torch.as_tensor(np.asarray(beta), device=device)
