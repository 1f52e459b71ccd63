"""Wrappers of the batched survival-curve kernels, the scoring hot path:
``survival_curves`` (``csrc/survival_curves.cu``) for a single baseline and
``survival_curves_stratified`` (``csrc/survival_curves_stratified.cu``) for
a baseline per request.

They replace the Pallas TPU kernels ``survival_curves`` and
``survival_curves_stratified`` of ``repro/kernels/survival_curves.py``.
"""
from __future__ import annotations

import torch

from . import _build, ref

Tensor = torch.Tensor

# calls that launched each CUDA kernel (the plain versions count nothing)
launches = 0
stratified_launches = 0


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


def survival_curves_stratified(eta: Tensor, h0: Tensor,
                               strata: Tensor) -> Tensor:
    """(b, g) S = exp(-h0[strata[b], g] * exp(clip(eta[b], -30, 30))).

    eta: (b,) linear predictors; h0: (s, g) cumulative baseline hazard per
    stratum; strata: (b,) row indices into h0. On a card eta and h0 are
    float32 and strata int32, and strata must lie in [0, s): the kernel
    does not check them on the device. On the CPU the plain version runs."""
    global stratified_launches
    if eta.dim() != 1 or h0.dim() != 2:
        raise ValueError(f"survival_curves_stratified: eta must be a vector "
                         f"and h0 an (s, g) table, got {tuple(eta.shape)} "
                         f"and {tuple(h0.shape)}")
    b, (s, g) = eta.shape[0], h0.shape
    on_card = _build.require(
        "survival_curves_stratified",
        {"eta": eta, "h0": h0, "strata": strata},
        {"eta": (b,), "h0": (s, g), "strata": (b,)},
        {"eta": torch.float32, "h0": torch.float32, "strata": torch.int32})
    if not on_card:
        return ref.survival_curves_stratified_ref(eta, h0, strata)
    out = torch.empty((b, g), dtype=torch.float32, device=eta.device)
    if b == 0 or g == 0:
        return out
    lib = _build.library()
    _build.check(lib.repro_survival_curves_stratified(
        eta.data_ptr(), h0.data_ptr(), strata.data_ptr(), b, g,
        out.data_ptr(), _build.stream()), "survival_curves_stratified")
    stratified_launches += 1
    return out
