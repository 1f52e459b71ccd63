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

# calls that launched the CUDA kernel (the plain version counts nothing)
launches = 0


def revcumsum(x: Tensor) -> Tensor:
    """out[i] = sum_{k >= i} x[k] along axis 0 of an (n,) or (n, m) tensor.

    On a card x is float32 or bfloat16; the sums run in float32 and the
    result takes x's type. On the CPU the plain version runs, in float64
    when given float64."""
    global launches
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
    lib = _build.library()
    scratch = torch.empty(lib.repro_revcumsum_scratch_floats(n, m),
                          dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    _build.check(lib.repro_revcumsum(
        x.data_ptr(), n, m, int(x.dtype == torch.bfloat16),
        scratch.data_ptr(), out.data_ptr(), _build.stream()), "revcumsum")
    launches += 1
    return out
