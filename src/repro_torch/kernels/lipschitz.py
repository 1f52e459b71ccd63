"""Wrapper of the Theorem-3.4 Lipschitz-constant kernel
(``csrc/lipschitz.cu``), run once per coordinate-descent fit.

Replaces the Pallas TPU kernel ``repro/kernels/lipschitz.py::lipschitz``.
Unlike that kernel it takes each sample's range at ``risk_start``, so it
equals ``core.cox.lipschitz_constants`` on tied times too. The source's
header says what bounds it on the card and how the design answers that.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, ref

Tensor = torch.Tensor

# kernel launches in one such call given ``group_events``
KERNELS_PER_CALL = 1
# the last epoch handed to the kernel (its carries and counters carry it)
_epoch = 0


def lipschitz(x: Tensor, delta: Tensor, risk_start: Tensor,
              group_events: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """(L2 (p,), L3 (p,)) of a time-sorted row-major (n, p) panel.

    On a card x and delta are float32 and risk_start int32; the kernel
    reads the tie groups' event counts ``group_events``
    (``ref.group_events(delta, risk_start)``, which a fit makes once and
    shares with ``cox_coord``), made by the call when not given. Given
    them, the call is one kernel launch and nothing else (its scratch is
    the wrapper's own, kept per device and stream). On the CPU the plain
    version runs, in float64 when given float64: the risk-start form, or
    the group-start form when ``group_events`` is given."""
    global _epoch
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"lipschitz: x must be a non-empty (n, p) panel, "
                         f"got shape {tuple(x.shape)}")
    n, p = x.shape
    args = {"x": x, "delta": delta, "risk_start": risk_start}
    dtypes = {"x": torch.float32, "delta": torch.float32,
              "risk_start": torch.int32}
    if group_events is not None:
        args["group_events"] = group_events
        dtypes["group_events"] = torch.float32
    shapes = dict.fromkeys(args, (n,))
    shapes["x"] = (n, p)
    if not _build.require("lipschitz", args, shapes, dtypes):
        if group_events is None:
            return ref.lipschitz_ref(x, delta, risk_start)
        # the group-start form: sum_s D[s] f(range(s)), range at s itself
        return ref.lipschitz_ref(x, group_events)
    if group_events is None:
        group_events = ref.group_events(delta, risk_start)
    lib = _build.library()
    dev, st = x.device, _build.stream()
    nbytes = lib.repro_lipschitz_scratch_bytes
    tagged = _build.scratch("lipschitz", nbytes(n, p, 0), torch.uint8, dev,
                            st)
    partials = _build.scratch("lipschitz.partials", nbytes(n, p, 1),
                              torch.uint8, dev, st)
    # nonzero, and never one a word of this scratch already holds
    _epoch = _epoch % 0x7FFFFFFF + 1
    out = torch.empty(2, p, dtype=torch.float32, device=dev)
    _build.check(lib.repro_lipschitz(
        x.data_ptr(), group_events.data_ptr(), n, p, tagged.data_ptr(),
        partials.data_ptr(), _epoch, out[0].data_ptr(), out[1].data_ptr(),
        st), "lipschitz")
    _build.LAUNCHES.add("lipschitz")
    return out[0], out[1]
