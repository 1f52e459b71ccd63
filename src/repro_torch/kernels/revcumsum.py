"""Wrapper of the suffix-sum kernel (``csrc/revcumsum.cu``), the scan under
the streaming fit's global mode.

Replaces the Pallas TPU kernel ``repro/kernels/revcumsum.py::revcumsum``.
The source's header says what bounds it on the card and how its two
layouts (m >= 32 columns, and narrower panels or vectors) answer that.
"""
from __future__ import annotations

import torch

from . import _build, ref

Tensor = torch.Tensor
_DTYPES = (torch.float32, torch.bfloat16)
PANEL_MIN_COLS = 32

# kernel launches in one such call, by layout
KERNELS_PER_CALL = {"panel": 1, "vector": 2}
# the last epoch handed to the kernel (the panel's carries carry it)
_epoch = 0


def revcumsum(x: Tensor) -> Tensor:
    """out[i] = sum_{k >= i} x[k] along axis 0 of an (n,) or (n, m) tensor.

    On a card x is float32 or bfloat16; the sums run in float32 and the
    result takes x's type. On the CPU the plain version runs, in float64
    when given float64."""
    global _epoch
    if x.dim() not in (1, 2) or 0 in x.shape:
        raise ValueError(f"revcumsum: x must be a non-empty (n,) or (n, m) "
                         f"tensor, got shape {tuple(x.shape)}")
    on_card = _build.require(
        "revcumsum", {"x": x}, {"x": tuple(x.shape)},
        {"x": x.dtype if x.dtype in _DTYPES else torch.float32})
    if not on_card:
        return ref.revcumsum_ref(x)
    n = x.shape[0]
    m = x.shape[1] if x.dim() == 2 else 1
    bf16 = int(x.dtype == torch.bfloat16)
    lib = _build.library()
    st = _build.stream()
    scratch = _build.scratch(
        "revcumsum", lib.repro_revcumsum_scratch_bytes(n, m, bf16),
        torch.uint8, x.device, st)
    # nonzero, and never one a carry word of this scratch already holds
    _epoch = _epoch % 0x7FFFFFFF + 1
    out = torch.empty_like(x)
    _build.check(lib.repro_revcumsum(
        x.data_ptr(), n, m, bf16, scratch.data_ptr(), _epoch, out.data_ptr(),
        st), "revcumsum")
    _build.LAUNCHES.add("revcumsum")
    return out
