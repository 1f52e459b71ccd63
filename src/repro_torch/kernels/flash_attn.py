"""Wrapper of the causal grouped-query flash-attention kernel
(``csrc/flash_attn.cu``): q k^T, the streaming softmax and P v of every
query head in one launch, reading q, k and v in place through their strides
and writing o once in bfloat16. It takes the (key, value) head dims in
``HEAD_DIMS``: (64, 64), Nemotron-H's (128, 128), and latent attention's
(192, 128), whose value heads are narrower than its query and key heads.

Replaces no TPU kernel: the JAX package's attention is plain ``jnp``, which
XLA fuses on the TPU. The plain version (``ref.flash_attention_ref``) runs
in float32 on CUDA cores over every block of the causal square and moves a
float32 score tensor through device memory per block; the kernel keeps the
scores in registers and computes no block above the diagonal. The source's
header says what bounds it and how the design answers.

``models/layers.py::flash_attention`` decides once, by ``takes_kernel``,
between ``ops.flash_attn`` and the plain version. Here the CPU takes the
plain version; a card input that ``takes_kernel`` refuses raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, ref

Tensor = torch.Tensor

# kernel launches in one such call, and no other device operation
KERNELS_PER_CALL = 1
# the (q and k, v) head dims the library instantiates: 64, Nemotron-H's
# 128, and Kimi Linear's latent attention (128 + 64 for q and k, 128 for v)
HEAD_DIMS = ((64, 64), (128, 128), (192, 128))
# the launch grid is (H, B, S / 64): y and z stop at 65,535
MAX_BATCH, MAX_LEN = 65_535, 65_535 * 64


def _rows_ok(t: Tensor) -> bool:
    """Each row's values contiguous, the data and every stride 16-byte
    aligned (bfloat16: multiples of 8 elements)."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st in t.stride()[:-1]))


def takes_kernel(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                 window: int, kv_len: Optional[Tensor]) -> bool:
    """The kernel takes causal attention over the whole sequence (no
    window, no ``kv_len``) of bfloat16 tensors on one card that need no
    gradient, q (B, S, H, dk), k (B, S, KH, dk) and v (B, S, KH, dv) with
    H a multiple of KH, (dk, dv) in HEAD_DIMS, B and S within the grid's
    limits and rows as ``_rows_ok`` says."""
    if not (q.is_cuda and causal and window <= 0 and kv_len is None):
        return False
    ts = (q, k, v)
    return (all(t.dtype == torch.bfloat16 and t.dim() == 4
                and t.device == q.device for t in ts)
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in ts))
            and k.shape[:3] == v.shape[:3] and k.shape[:2] == q.shape[:2]
            and k.shape[3] == q.shape[3]
            and 1 <= q.shape[1] <= MAX_LEN and q.shape[0] <= MAX_BATCH
            and (q.shape[3], v.shape[3]) in HEAD_DIMS
            and q.shape[2] % k.shape[2] == 0
            and all(_rows_ok(t) for t in ts))


def flash_attn(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Causal GQA, o (B, S, H, dv) in q's dtype: query head h reads KV
    head h // (H / KH), scaled by dk^-1/2. On a card one kernel launch,
    for inputs that ``takes_kernel`` accepts, and a raise for any other;
    on the CPU the plain version."""
    if not q.is_cuda:
        return ref.flash_attention_ref(q, k, v, causal=True)
    if q.dim() != 4 or v.dim() != 4 or (q.shape[3],
                                        v.shape[3]) not in HEAD_DIMS:
        raise ValueError(f"flash_attn: head dims of q {tuple(q.shape)} and "
                         f"v {tuple(v.shape)} are not instantiated; the "
                         f"kernel takes (dk, dv) in {HEAD_DIMS}")
    if not takes_kernel(q, k, v, causal=True, window=-1, kv_len=None):
        raise TypeError(
            f"flash_attn: the kernel takes bfloat16 q (B, S, H, dk), k (B, "
            f"S, KH, dk) and v (B, S, KH, dv) on one card, H a multiple of "
            f"KH, needing no gradient, with contiguous 16-byte aligned rows; "
            f"got q {tuple(q.shape)} {q.dtype} strides {q.stride()}, k "
            f"{tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} {v.dtype}")
    b, s, h, dk = q.shape
    dv = v.shape[3]
    o = torch.empty(b, s, h, dv, dtype=q.dtype, device=q.device)
    _build.check(_build.library().repro_flash_attn(
        q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
        v.data_ptr(), *v.stride()[:3], o.data_ptr(), b, s, h, k.shape[2], dk,
        dv, _build.stream()), "flash_attn")
    _build.LAUNCHES.add("flash_attn")
    return o
