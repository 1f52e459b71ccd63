"""Wrapper of the fused per-coordinate derivative kernel
(``csrc/cox_coord.cu``), the coordinate-descent inner step.

Replaces the Pallas TPU kernel ``repro/kernels/cox_coord.py::cox_coord``.
Unlike that kernel it reads every risk set at ``risk_start``, so it is exact
on tied times (Breslow) as well as on tie-free ones. The source's header
says what bounds it on the card and how the design answers that.
"""
from __future__ import annotations

import torch

from . import _build, ref

Tensor = torch.Tensor

# calls that launched the CUDA kernel (the plain version counts nothing)
launches = 0


def cox_coord(eta: Tensor, x: Tensor, delta: Tensor, risk_start: Tensor,
              order: int = 2) -> Tensor:
    """(3,) tensor (g, h, c3) of one coordinate; c3 is 0 for order 2.

    eta, x, delta: (n,) float32 on a card, time-sorted; risk_start: (n,)
    int32, the first index of each sample's tie group. On the CPU the plain
    version runs, in float64 when given float64."""
    global launches
    if order not in (2, 3):
        raise ValueError(f"order must be 2 or 3, got {order}")
    n = eta.shape[0] if eta.dim() == 1 else -1
    if n < 1:
        raise ValueError(f"cox_coord: eta must be a non-empty vector, got "
                         f"shape {tuple(eta.shape)}")
    args = {"eta": eta, "x": x, "delta": delta, "risk_start": risk_start}
    on_card = _build.require(
        "cox_coord", args, dict.fromkeys(args, (n,)),
        {"eta": torch.float32, "x": torch.float32, "delta": torch.float32,
         "risk_start": torch.int32})
    if not on_card:
        return torch.stack(ref.cox_coord_ref(eta, x, delta, risk_start,
                                             order=order))
    lib = _build.library()
    eta_max = torch.max(eta).reshape(1)
    scratch = torch.empty(lib.repro_cox_coord_scratch_floats(n, order),
                          dtype=torch.float32, device=eta.device)
    out = torch.empty(3, dtype=torch.float32, device=eta.device)
    _build.check(lib.repro_cox_coord(
        eta.data_ptr(), x.data_ptr(), delta.data_ptr(), risk_start.data_ptr(),
        eta_max.data_ptr(), n, order, scratch.data_ptr(), out.data_ptr(),
        _build.stream()), "cox_coord")
    launches += 1
    return out
