"""Wrapper of the fused per-coordinate derivative kernel
(``csrc/cox_coord.cu``), the coordinate-descent inner step.

Replaces the Pallas TPU kernel ``repro/kernels/cox_coord.py::cox_coord``.
Unlike that kernel it reads every risk set at its tie group's start, so it
is exact on tied times (Breslow) as well as on tie-free ones: it takes the
per-group event counts ``group_events`` (made once per fit) in place of
``risk_start``. The source's header says what bounds it on the card and how
the design answers that.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, ref

Tensor = torch.Tensor

# kernel launches in one such call, and samples a block takes (kTile in
# csrc/cox_coord.cu)
KERNELS_PER_CALL = 2
TILE = 1024


def cox_coord(eta: Tensor, x: Tensor, delta: Tensor, risk_start: Tensor,
              order: int = 2, group_events: Optional[Tensor] = None
              ) -> Tensor:
    """(3,) tensor (g, h, c3) of one coordinate; c3 is 0 for order 2.

    eta, x, delta: (n,) float32 on a card, time-sorted; risk_start: (n,)
    int32, the first index of each sample's tie group. ``group_events``
    (``ref.group_events(delta, risk_start)``) may be passed in, as a fit
    makes it once; without it the call makes it. On the CPU the plain
    version runs, in float64 when given float64: the risk-start form, or
    the group-start form when ``group_events`` is given.

    On a card the call is two kernel launches when ``group_events`` is
    given, and nothing else: the returned tensor is the wrapper's own
    buffer for this device and stream, overwritten by the next call there.
    Clone it to keep it."""
    if order not in (2, 3):
        raise ValueError(f"order must be 2 or 3, got {order}")
    n = eta.shape[0] if eta.dim() == 1 else -1
    if n < 1:
        raise ValueError(f"cox_coord: eta must be a non-empty vector, got "
                         f"shape {tuple(eta.shape)}")
    args = {"eta": eta, "x": x, "delta": delta, "risk_start": risk_start}
    dtypes = {"eta": torch.float32, "x": torch.float32,
              "delta": torch.float32, "risk_start": torch.int32}
    if group_events is not None:
        args["group_events"] = group_events
        dtypes["group_events"] = torch.float32
    on_card = _build.require("cox_coord", args, dict.fromkeys(args, (n,)),
                             dtypes)
    if not on_card:
        if group_events is None:
            return torch.stack(ref.cox_coord_ref(eta, x, delta, risk_start,
                                                 order=order))
        return torch.stack(ref.cox_coord_groups_ref(eta, x, delta,
                                                    group_events, order))
    if group_events is None:
        group_events = ref.group_events(delta, risk_start)
    lib = _build.library()
    dev, st = eta.device, _build.stream()
    scratch = _build.scratch("cox_coord",
                             lib.repro_cox_coord_scratch_floats(n, order),
                             torch.float32, dev, st)
    out = _build.scratch("cox_coord.out", 3, torch.float32, dev, st)
    _build.check(lib.repro_cox_coord(
        eta.data_ptr(), x.data_ptr(), delta.data_ptr(),
        group_events.data_ptr(), n, order, scratch.data_ptr(),
        out.data_ptr(), st), "cox_coord")
    _build.LAUNCHES.add("cox_coord")
    return out
