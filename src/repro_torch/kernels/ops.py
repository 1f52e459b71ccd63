"""Public entry points to the kernels, as the JAX package's ``kernels/ops.py``.

Each call dispatches to one wrapper, which picks its own route: a tensor on
a card launches the CUDA kernel (or raises where the kernel does not take
it), a tensor on the CPU takes the plain version in ``ref.py``. Every
dispatch counts in ``kernel_dispatch_total``, labelled with the kernel and
the route taken (``cuda`` or ``plain``), so a fleet that silently ran the
plain version would show it in the metrics. The wrappers' launch counts
(``launch_counts()``, kept in ``_build.LAUNCHES`` under a lock, as the
serving threads launch from several host threads) count the calls that
launched their kernels and nothing else; a call may be several launches
(every wrapper module states its own in ``KERNELS_PER_CALL``:
``cox_coord`` 2, ``revcumsum`` 1 or 2 by layout, ``cox_batch``,
``lipschitz``, both curve kernels, ``ssd_scan`` and ``flash_attn`` 1). A
``cox_coord`` call over C candidates counts C, one a candidate coordinate,
in both.

Each kernel picks its own launch shape; the curve kernels read theirs
(``blocks_per_sm``) from ``autotune.knob``, the default where untuned.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..obs import metrics as obs_metrics
from . import _build
from . import cox_batch as _cox_batch
from . import cox_coord as _cox_coord
from . import flash_attn as _flash_attn
from . import lipschitz as _lipschitz
from . import ref
from . import revcumsum as _revcumsum
from . import ssd_scan as _ssd_scan
from . import survival_curves as _survival_curves

Tensor = torch.Tensor

_M_DISPATCH = obs_metrics.REGISTRY.counter(
    "kernel_dispatch_total", "kernel dispatches by route",
    ("kernel", "route"))

# every wrapper's kernel, by the name its launches count under
KERNELS = ("cox_coord", "lipschitz", "survival_curves", "revcumsum",
           "cox_batch", "survival_curves_stratified", "ssd_scan",
           "flash_attn")


def _count(kernel: str, t: Tensor, calls: int = 1) -> None:
    _M_DISPATCH.inc(calls, kernel=kernel,
                    route="cuda" if t.device.type == "cuda" else "plain")


def launch_counts() -> Dict[str, int]:
    """Calls that launched their kernels, per wrapper, since the last
    reset."""
    return _build.LAUNCHES.read(KERNELS)


def reset_launch_counts() -> None:
    _build.LAUNCHES.reset()


def revcumsum(x: Tensor) -> Tensor:
    """Suffix sum along axis 0; takes (n,) or (n, m)."""
    _count("revcumsum", x)
    return _revcumsum.revcumsum(x)


def group_events(delta: Tensor, risk_start: Tensor) -> Tensor:
    """Per-tie-group event counts at each group's start, for
    ``cox_coord_grad_hess``, ``cox_coord_all`` and ``lipschitz_constants``;
    make it once per fit."""
    return ref.group_events(delta, risk_start)


def cox_coord_grad_hess(eta: Tensor, x: Tensor, delta: Tensor,
                        risk_start: Tensor,
                        group_events: Optional[Tensor] = None
                        ) -> Tuple[Tensor, Tensor]:
    """Fused per-coordinate (g, h), exact on tied times; (C,) each given a
    (C, n) ``eta`` and ``x``. ``group_events`` (``group_events``) is made by
    the call when not given."""
    _count("cox_coord", eta, eta.shape[0] if eta.dim() == 2 else 1)
    out = _cox_coord.cox_coord(eta, x, delta, risk_start, order=2,
                               group_events=group_events)
    return out[..., 0], out[..., 1]


def cox_coord_all(eta: Tensor, x: Tensor, delta: Tensor,
                  risk_start: Tensor, group_events: Optional[Tensor] = None
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused per-coordinate (g, h, c3) including the third partial."""
    _count("cox_coord", eta)
    out = _cox_coord.cox_coord(eta, x, delta, risk_start, order=3,
                               group_events=group_events)
    return out[0], out[1], out[2]


def cox_coord_step(eta: Tensor, rows: Tensor, j: int, prev: Optional[int],
                   beta: Tensor, curv: Tensor, step: Tensor, delta: Tensor,
                   group_events: Tensor, lam2: float) -> Tensor:
    """One quadratic-surrogate coordinate step of C candidates in place:
    the pending update from column ``prev``, (g, h) at column j, and the
    step into ``beta`` and ``step`` (``cox_coord.cox_coord_step``; on a
    card only)."""
    _count("cox_coord", eta, eta.shape[0])
    return _cox_coord.cox_coord_step(eta, rows, j, prev, beta, curv, step,
                                     delta, group_events, lam2)


def lipschitz_constants(x: Tensor, delta: Tensor, risk_start: Tensor,
                        group_events: Optional[Tensor] = None
                        ) -> Tuple[Tensor, Tensor]:
    """(L2, L3) Theorem-3.4 constants, exact on tied times; takes the same
    optional ``group_events`` as ``cox_coord_grad_hess``."""
    _count("lipschitz", x)
    return _lipschitz.lipschitz(x, delta, risk_start,
                                group_events=group_events)


def cox_batch_grad_hess(eta: Tensor, x: Tensor,
                        delta: Tensor) -> Tuple[Tensor, Tensor]:
    """All-coordinate (grad, hess_diag) of tie-free, time-sorted rows.

    The O(n) vectors are formed here in plain torch, in float32 (float64
    when given float64), as the reference leaves them to XLA; the O(n p)
    panel work runs in the kernel."""
    _count("cox_batch", x)
    wt = torch.promote_types(torch.promote_types(eta.dtype, x.dtype),
                             torch.float32)
    eta, d = eta.to(wt), delta.to(wt)
    w = torch.exp(eta - torch.max(eta))
    inv_s0 = 1.0 / ref._suffix(w)
    wa = w * torch.cumsum(d * inv_s0, 0)
    return _cox_batch.cox_batch(x, w, wa - d, wa, d, inv_s0)


def survival_curves(eta: Tensor, h0: Tensor) -> Tensor:
    """Fused (batch x grid) survival curves: the serving hot path."""
    _count("survival_curves", eta)
    return _survival_curves.survival_curves(eta, h0)


def survival_curves_stratified(eta: Tensor, h0: Tensor,
                               strata: Tensor) -> Tensor:
    """Curves with a baseline row per request: h0 is (s, g), strata (b,)
    row indices; the row is read inside the kernel, never gathered into a
    (b, g) copy."""
    _count("survival_curves_stratified", eta)
    return _survival_curves.survival_curves_stratified(eta, h0, strata)


def ssd_scan(xh: Tensor, dt: Tensor, a: Tensor, bb: Tensor, cc: Tensor,
             d_skip: Tensor, chunk: int, n_groups: int,
             return_state: bool = False
             ) -> Tuple[Tensor, Optional[Tensor]]:
    """The Mamba2 mixer's chunked SSD with its skip term, y in xh's dtype
    (B, S, H, hd), and the final state with ``return_state``
    (``ssd_scan.ssd_scan``)."""
    _count("ssd_scan", xh)
    return _ssd_scan.ssd_scan(xh, dt, a, bb, cc, d_skip, chunk, n_groups,
                              return_state)


def flash_attn(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Causal GQA over the whole sequence, o (B, S, H, dv) in q's dtype,
    query head h reading KV head h // (H / KH)
    (``flash_attn.flash_attn``)."""
    _count("flash_attn", q)
    return _flash_attn.flash_attn(q, k, v)
