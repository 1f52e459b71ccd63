"""Public entry points to the kernels, as the JAX package's ``kernels/ops.py``.

Each call dispatches to one wrapper: a tensor on a card launches the CUDA
kernel, a tensor on the CPU takes the plain version (``ref.py``). Every
dispatch counts in ``kernel_dispatch_total``, labelled with the kernel and
the route taken (``cuda`` or ``plain``), so a fleet that silently ran the
plain version would show it in the metrics. The wrappers' own ``launches``
counts (``launch_counts()``) count kernel launches only.

The port has no block autotuner: each kernel picks its own launch shape.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..obs import metrics as obs_metrics
from . import cox_coord as _cox_coord
from . import lipschitz as _lipschitz
from . import survival_curves as _survival_curves

Tensor = torch.Tensor

_M_DISPATCH = obs_metrics.REGISTRY.counter(
    "kernel_dispatch_total", "kernel dispatches by route",
    ("kernel", "route"))

_WRAPPERS = {"cox_coord": _cox_coord, "lipschitz": _lipschitz,
             "survival_curves": _survival_curves}


def _count(kernel: str, t: Tensor) -> None:
    _M_DISPATCH.inc(kernel=kernel,
                    route="cuda" if t.device.type == "cuda" else "plain")


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: mod.launches for name, mod in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for mod in _WRAPPERS.values():
        mod.launches = 0


def cox_coord_grad_hess(eta: Tensor, x: Tensor, delta: Tensor,
                        risk_start: Tensor) -> Tuple[Tensor, Tensor]:
    """Fused per-coordinate (g, h), exact on tied times."""
    _count("cox_coord", eta)
    out = _cox_coord.cox_coord(eta, x, delta, risk_start, order=2)
    return out[0], out[1]


def cox_coord_all(eta: Tensor, x: Tensor, delta: Tensor,
                  risk_start: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused per-coordinate (g, h, c3) including the third partial."""
    _count("cox_coord", eta)
    out = _cox_coord.cox_coord(eta, x, delta, risk_start, order=3)
    return out[0], out[1], out[2]


def lipschitz_constants(x: Tensor, delta: Tensor,
                        risk_start: Tensor) -> Tuple[Tensor, Tensor]:
    """(L2, L3) Theorem-3.4 constants, exact on tied times."""
    _count("lipschitz", x)
    return _lipschitz.lipschitz(x, delta, risk_start)


def survival_curves(eta: Tensor, h0: Tensor) -> Tensor:
    """Fused (batch x grid) survival curves: the serving hot path."""
    _count("survival_curves", eta)
    return _survival_curves.survival_curves(eta, h0)
