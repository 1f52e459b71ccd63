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


def _buffers(lib, n: int, order: int, c: int, dev, st):
    """The wrapper's scratch, its C tickets (zero between calls) and its
    (C, 3) output, kept per device and stream."""
    return (_build.scratch("cox_coord",
                           lib.repro_cox_coord_scratch_floats(n, order, c),
                           torch.float32, dev, st),
            _build.scratch("cox_coord.tickets", c, torch.int32, dev, st),
            _build.scratch("cox_coord.out", 3 * c, torch.float32, dev, st))


def cox_coord(eta: Tensor, x: Tensor, delta: Tensor, risk_start: Tensor,
              order: int = 2, group_events: Optional[Tensor] = None
              ) -> Tensor:
    """(3,) tensor (g, h, c3) of one coordinate; c3 is 0 for order 2. Given
    a (C, n) ``eta`` and ``x`` (a candidate a row), (C, 3): each row what a
    call on that row's eta and column gives, bit for bit on a card.

    eta, x: (n,) or (C, n) float32 on a card, time-sorted; delta: (n,);
    risk_start: (n,) int32, the first index of each sample's tie group.
    ``group_events`` (``ref.group_events(delta, risk_start)``) may be
    passed in, as a fit makes it once; without it the call makes it. On the
    CPU the plain version runs, in float64 when given float64: the
    risk-start form, or the group-start form when ``group_events`` is
    given.

    On a card the call is two kernel launches when ``group_events`` is
    given, and nothing else: the returned tensor is a view of the
    wrapper's own buffer for this device and stream, overwritten by the
    next call there. Clone it to keep it. The launch count rises by C."""
    if order not in (2, 3):
        raise ValueError(f"order must be 2 or 3, got {order}")
    if eta.dim() not in (1, 2) or eta.numel() < 1:
        raise ValueError(f"cox_coord: eta must be a non-empty (n,) or "
                         f"(C, n) tensor, got shape {tuple(eta.shape)}")
    n, c = eta.shape[-1], (eta.shape[0] if eta.dim() == 2 else 1)
    args = {"eta": eta, "x": x, "delta": delta, "risk_start": risk_start}
    dtypes = {"eta": torch.float32, "x": torch.float32,
              "delta": torch.float32, "risk_start": torch.int32}
    if group_events is not None:
        args["group_events"] = group_events
        dtypes["group_events"] = torch.float32
    shapes = dict.fromkeys(args, (n,))
    shapes["eta"] = shapes["x"] = tuple(eta.shape)
    on_card = _build.require("cox_coord", args, shapes, dtypes)
    if not on_card:
        if eta.dim() == 2:
            return torch.stack([cox_coord(e, xr, delta, risk_start, order,
                                          group_events)
                                for e, xr in zip(eta, x)])
        if group_events is None:
            return torch.stack(ref.cox_coord_ref(eta, x, delta, risk_start,
                                                 order=order))
        return torch.stack(ref.cox_coord_groups_ref(eta, x, delta,
                                                    group_events, order))
    if group_events is None:
        group_events = ref.group_events(delta, risk_start)
    lib = _build.library()
    dev, st = eta.device, _build.stream()
    scratch, tickets, out = _buffers(lib, n, order, c, dev, st)
    _build.check(lib.repro_cox_coord(
        eta.data_ptr(), x.data_ptr(), delta.data_ptr(),
        group_events.data_ptr(), n, c, order, scratch.data_ptr(),
        tickets.data_ptr(), out.data_ptr(), st), "cox_coord")
    _build.LAUNCHES.add("cox_coord", c)
    return out[:3 * c].view(c, 3) if eta.dim() == 2 else out[:3]


def cox_coord_step(eta: Tensor, rows: Tensor, j: int, prev: Optional[int],
                   beta: Tensor, curv: Tensor, step: Tensor, delta: Tensor,
                   group_events: Tensor, lam2: float) -> Tensor:
    """One quadratic-surrogate coordinate step of C candidates at once, in
    place: the batched finetune's inner step.

    eta (C, n), each candidate's linear predictor; rows (C, s, n), its s
    support columns; beta and curv (C, s), its coefficients and its
    columns' L2 + 2 lam2; step (C,), the step each candidate took last.
    First the step pending from column ``prev`` (None: none pending) is
    applied, eta[c] += rows[c, prev] * step[c]; then column j's (g, h) of
    every candidate, as ``cox_coord`` gives them from that eta; then
    ``surrogate.quad_min``'s step -(g + 2 lam2 beta[c, j]) / curv[c, j],
    added to beta[c, j] and written to step[c]. The caller applies the
    last step's eta update itself. Returns (C, 3) (g, h, 0), a view of the
    wrapper's buffer as ``cox_coord``'s.

    Float32 on a card only: two kernel launches and nothing else; the
    launch count rises by C. Its plain version is the eager step of
    ``solvers.coord_step``, which runs it elsewhere."""
    if rows.dim() != 3 or rows.numel() < 1:
        raise ValueError(f"cox_coord_step: rows must be a non-empty "
                         f"(C, s, n) tensor, got {tuple(rows.shape)}")
    c, s, n = rows.shape
    if not (0 <= j < s and (prev is None or 0 <= prev < s)):
        raise ValueError(f"cox_coord_step: columns {j}, {prev} of {s}")
    args = {"eta": eta, "rows": rows, "beta": beta, "curv": curv,
            "step": step, "delta": delta, "group_events": group_events}
    shapes = {"eta": (c, n), "rows": (c, s, n), "beta": (c, s),
              "curv": (c, s), "step": (c,), "delta": (n,),
              "group_events": (n,)}
    if not _build.require("cox_coord", args, shapes,
                          dict.fromkeys(args, torch.float32)):
        raise ValueError("cox_coord_step: the fused step runs on a card "
                         "only; solvers.coord_step takes the eager step "
                         "elsewhere")
    lib = _build.library()
    dev, st = eta.device, _build.stream()
    scratch, tickets, out = _buffers(lib, n, 2, c, dev, st)
    col = 4 * n                                    # bytes of a column
    _build.check(lib.repro_cox_coord_step(
        eta.data_ptr(), rows.data_ptr() + j * col,
        None if prev is None else rows.data_ptr() + prev * col, s * n,
        delta.data_ptr(), group_events.data_ptr(), n, c,
        beta.data_ptr() + 4 * j, curv.data_ptr() + 4 * j, s, 2.0 * lam2,
        step.data_ptr(), scratch.data_ptr(), tickets.data_ptr(),
        out.data_ptr(), st), "cox_coord_step")
    _build.LAUNCHES.add("cox_coord", c)
    return out[:3 * c].view(c, 3)
