"""Wrapper of the all-coordinate gradient and diagonal-Hessian kernel
(``csrc/cox_batch.cu``), the streaming fit's chunk-mode step.

Replaces the Pallas TPU kernel ``repro/kernels/cox_batch.py::cox_batch``.
Like that kernel it is tie-free: every row's risk set is its own suffix,
which is the contract of a streaming chunk. The source's header says what
bounds it on the card and how the design answers that.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build, ref

Tensor = torch.Tensor
_DTYPES = (torch.float32, torch.bfloat16)

# calls that launched the CUDA kernel (the plain version counts nothing)
launches = 0


def cox_batch(x: Tensor, w: Tensor, r: Tensor, wa: Tensor, delta: Tensor,
              inv_s0: Tensor) -> Tuple[Tensor, Tensor]:
    """(grad (p,), hess_diag (p,)) of a time-sorted, tie-free (n, p) panel.

    On a card x is float32 or bfloat16 and the five (n,) vectors float32;
    both outputs are float32. On the CPU the plain version runs, in float64
    when given float64."""
    global launches
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"cox_batch: x must be a non-empty (n, p) panel, "
                         f"got shape {tuple(x.shape)}")
    n, p = x.shape
    vecs = {"w": w, "r": r, "wa": wa, "delta": delta, "inv_s0": inv_s0}
    on_card = _build.require(
        "cox_batch", {"x": x, **vecs},
        {"x": (n, p), **dict.fromkeys(vecs, (n,))},
        {"x": x.dtype if x.dtype in _DTYPES else torch.float32,
         **dict.fromkeys(vecs, torch.float32)})
    if not on_card:
        return ref.cox_batch_ref(x, w, r, wa, delta, inv_s0)
    lib = _build.library()
    scratch = torch.empty(lib.repro_cox_batch_scratch_bytes(n, p),
                          dtype=torch.uint8, device=x.device)
    grad = torch.empty(p, dtype=torch.float32, device=x.device)
    hess = torch.empty(p, dtype=torch.float32, device=x.device)
    _build.check(lib.repro_cox_batch(
        x.data_ptr(), w.data_ptr(), r.data_ptr(), wa.data_ptr(),
        delta.data_ptr(), inv_s0.data_ptr(), n, p,
        int(x.dtype == torch.bfloat16), scratch.data_ptr(), grad.data_ptr(),
        hess.data_ptr(), _build.stream()), "cox_batch")
    launches += 1
    return grad, hess
