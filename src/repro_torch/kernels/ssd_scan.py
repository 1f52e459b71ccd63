"""Wrapper of the chunked SSD scan kernel of the Mamba2 mixer
(``csrc/ssd_scan.cu``): the scan, its skip term D x and the rounding of y
to the model's dtype in one launch, reading x, B and C in place from the
conv output.

Replaces no TPU kernel: the JAX package runs its SSD in plain ``jnp``,
which XLA fuses on the TPU. The port's eager form (``models/ssm.py``'s
``_ssd_chunked`` and ``_ssd_chunked_grouped``) builds its (Q, Q, heads)
decay and weight tensors in float32 in device memory, and most of a Mamba2
forward's card time went to moving them; the kernel keeps them in
registers. The source's header says what bounds it and how the design
answers.

The eager form is the plain version (``models/ssm.py::ssd_eager``): the
CPU takes it, and a CUDA tensor of a shape the library does not
instantiate raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

Tensor = torch.Tensor

# kernel launches in one such call, and no other device operation
KERNELS_PER_CALL = 1
# the (head_dim, d_state, chunk) the library instantiates, as
# ``repro_ssd_scan`` dispatches them: mamba2-130m and Nemotron-H,
# zamba2-2.7b, the reduced configs
SHAPES = ((64, 128, 128), (64, 64, 64), (16, 16, 16))


def _rows(t: Tensor, what: str) -> Tuple[int, int]:
    """(batch stride, row stride) of a (B, S, ...) view whose innermost
    values are contiguous, in elements, 16-byte aligned."""
    if t.stride(-1) != 1 or t.data_ptr() % 16 or t.stride(1) % 8 \
            or t.stride(0) % 8:
        raise ValueError(f"ssd_scan: {what} must have contiguous, 16-byte "
                         f"aligned rows; strides {t.stride()}")
    return t.stride(0), t.stride(1)


def ssd_scan(xh: Tensor, dt: Tensor, a: Tensor, bb: Tensor, cc: Tensor,
             d_skip: Tensor, chunk: int, n_groups: int,
             return_state: bool = False
             ) -> Tuple[Tensor, Optional[Tensor]]:
    """y = SSD(x) + D x in xh's dtype, (B, S, H, hd), and with
    ``return_state`` the final state (B, H, hd, N) float32, else None.

    xh (B, S, H, hd) and bb, cc (B, S, G N) may be strided views of one
    (B, S, channels) tensor (rows need not be contiguous, their values
    must); dt (B, S, H), a and d_skip (H,) float32. On a card xh, bb and cc
    are bfloat16, (hd, N, chunk) one of SHAPES, and the call is one kernel
    launch and nothing else. On the CPU the plain version runs, and
    returns the state whatever ``return_state`` says."""
    b, s, h, hd = xh.shape
    n = bb.shape[-1] // n_groups
    if (bb.shape != (b, s, n_groups * n) or cc.shape != bb.shape
            or dt.shape != (b, s, h) or a.shape != (h,)
            or d_skip.shape != (h,) or h % n_groups or s < 1):
        raise ValueError(f"ssd_scan: shapes x {tuple(xh.shape)}, B "
                         f"{tuple(bb.shape)}, C {tuple(cc.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(a.shape)}, D "
                         f"{tuple(d_skip.shape)}, groups {n_groups}")
    if xh.device.type != "cuda":
        from ..models import ssm  # the models import the kernels

        return ssm.ssd_eager(xh, dt, a, bb, cc, d_skip, chunk, n_groups)
    if (hd, n, chunk) not in SHAPES:
        raise ValueError(f"ssd_scan: (head_dim, d_state, chunk) = "
                         f"{(hd, n, chunk)} is not instantiated; the kernel "
                         f"takes {SHAPES}")
    if {xh.dtype, bb.dtype, cc.dtype} != {torch.bfloat16} or any(
            t.dtype != torch.float32 for t in (dt, a, d_skip)):
        raise TypeError("ssd_scan: the kernel takes bfloat16 x, B, C and "
                        "float32 dt, A, D")
    if xh.stride(2) != hd or bb.stride() != cc.stride():
        raise ValueError(f"ssd_scan: heads must lie side by side in a row "
                         f"and B, C share strides; strides x {xh.stride()},"
                         f" B {bb.stride()}, C {cc.stride()}")
    x_bs, x_rs = _rows(xh, "x")
    bc_bs, bc_rs = _rows(bb, "B")
    _rows(cc, "C")
    dev = xh.device
    for name, t in (("dt", dt), ("A", a), ("D", d_skip), ("B", bb),
                    ("C", cc)):
        if t.device != dev:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, "
                             f"expected {dev}")
    dt, a, d_skip = dt.contiguous(), a.contiguous(), d_skip.contiguous()
    y = torch.empty(b, s, h, hd, dtype=xh.dtype, device=dev)
    st = (torch.empty(b, h, hd, n, dtype=torch.float32, device=dev)
          if return_state else None)
    lib = _build.library()
    _build.check(lib.repro_ssd_scan(
        xh.data_ptr(), x_bs, x_rs, bb.data_ptr(), cc.data_ptr(), bc_bs,
        bc_rs, dt.data_ptr(), a.data_ptr(), d_skip.data_ptr(), y.data_ptr(),
        st.data_ptr() if st is not None else None, b, s, h, n_groups, hd, n,
        chunk, _build.stream()), "ssd_scan")
    _build.LAUNCHES.add("ssd_scan")
    return y, st
