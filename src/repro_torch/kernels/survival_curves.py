"""Wrapper of the batched survival-curve kernel
(``csrc/survival_curves.cu``), the scoring hot path.

Replaces the Pallas TPU kernel
``repro/kernels/survival_curves.py::survival_curves``. The stratified
variant (``survival_curves_stratified``) is not ported yet.
"""
from __future__ import annotations

import torch

from . import _build, ref

Tensor = torch.Tensor

# calls that launched the CUDA kernel (the plain version counts nothing)
launches = 0


def survival_curves(eta: Tensor, h0: Tensor) -> Tensor:
    """(b, g) S = exp(-h0[g] * exp(clip(eta[b], -30, 30))).

    eta: (b,) linear predictors; h0: (g,) cumulative baseline hazard, both
    float32 on a card. On the CPU the plain version runs."""
    global launches
    if eta.dim() != 1 or h0.dim() != 1:
        raise ValueError(f"survival_curves: eta and h0 must be vectors, got "
                         f"{tuple(eta.shape)} and {tuple(h0.shape)}")
    b, g = eta.shape[0], h0.shape[0]
    on_card = _build.require(
        "survival_curves", {"eta": eta, "h0": h0},
        {"eta": (b,), "h0": (g,)},
        {"eta": torch.float32, "h0": torch.float32})
    if not on_card:
        return ref.survival_curves_ref(eta, h0)
    out = torch.empty((b, g), dtype=torch.float32, device=eta.device)
    if b == 0 or g == 0:
        return out
    lib = _build.library()
    _build.check(lib.repro_survival_curves(
        eta.data_ptr(), h0.data_ptr(), b, g, out.data_ptr(), _build.stream()),
        "survival_curves")
    launches += 1
    return out
