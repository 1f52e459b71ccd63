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

# kernel launches in one such call
KERNELS_PER_CALL = 1
# the last epoch handed to the kernel (its carries and counters carry it)
_epoch = 0


def cox_batch(x: Tensor, w: Tensor, r: Tensor, wa: Tensor, delta: Tensor,
              inv_s0: Tensor) -> Tuple[Tensor, Tensor]:
    """(grad (p,), hess_diag (p,)) of a time-sorted, tie-free (n, p) panel.

    On a card x is float32 or bfloat16 and the five (n,) vectors float32;
    both outputs are float32, and the call is one kernel launch and
    nothing else (its scratch is the wrapper's own, kept per device and
    stream). On the CPU the plain version runs, in float64 when given
    float64."""
    global _epoch
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
    bf16 = int(x.dtype == torch.bfloat16)
    lib = _build.library()
    dev, st = x.device, _build.stream()
    nbytes = lib.repro_cox_batch_scratch_bytes
    tagged = _build.scratch("cox_batch", nbytes(n, p, bf16, 0), torch.uint8,
                            dev, st)
    partials = _build.scratch("cox_batch.partials", nbytes(n, p, bf16, 1),
                              torch.uint8, dev, st)
    # nonzero, and never one a word of this scratch already holds
    _epoch = _epoch % 0x7FFFFFFF + 1
    out = torch.empty(2, p, dtype=torch.float32, device=dev)
    _build.check(lib.repro_cox_batch(
        x.data_ptr(), w.data_ptr(), r.data_ptr(), wa.data_ptr(),
        delta.data_ptr(), inv_s0.data_ptr(), n, p, bf16, tagged.data_ptr(),
        partials.data_ptr(), _epoch, out[0].data_ptr(), out[1].data_ptr(),
        st), "cox_batch")
    _build.LAUNCHES.add("cox_batch")
    return out[0], out[1]
