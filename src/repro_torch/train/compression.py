"""Gradient compression for the data-parallel all-reduce.

The PyTorch port's counterpart of the JAX package's
``train/compression.py``: int8 block quantization with error feedback.
Each gradient is scaled per 256-element block to int8 and the quantization
error is carried in a residual that is added back at the next step (error
feedback keeps SGD/Adam convergence, Karimireddy et al. 2019).

``compressed_psum`` is the all-reduce itself on a ``torch.distributed``
group; ``compress_decompress`` is the same quantization as a gradient
transform on one process. Like the reference's trainer, the port's does not
read ``TrainConfig.grad_compression``: both are library functions
(ROADMAP C9).
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as dist

Tensor = torch.Tensor
BLOCK = 256


def _blocks(x: Tensor) -> Tensor:
    flat = x.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    return flat.reshape(-1, BLOCK)


def _scale(blocks: Tensor) -> Tensor:
    return torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0 + 1e-12


def _quant(x: Tensor) -> Tuple[Tensor, Tensor]:
    """(int8 blocks (nb, 256), float32 scales (nb, 1)) of ``x``."""
    blocks = _blocks(x)
    scale = _scale(blocks)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: Tensor, scale: Tensor, shape) -> Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def compress_decompress(grads: Mapping[str, Tensor],
                        residual: Mapping[str, Tensor]
                        ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """Error-feedback int8 round trip: returns (grads_hat, new_residual),
    each keyed as ``grads``."""
    out, res = {}, {}
    for k, g in grads.items():
        x = g.float() + residual[k]
        q, s = _quant(x)
        xh = _dequant(q, s, g.shape)
        out[k] = xh.to(g.dtype)
        res[k] = x - xh
    return out, res


def compressed_psum(x: Tensor, group=None) -> Tensor:
    """int8 all-reduce over ``group`` (default the default group): agree
    on a shared per-block scale (one ``all_reduce(MAX)``), quantize against
    it, sum the int8 payloads as int32 (one ``all_reduce(SUM)``; exact for
    up to 2^23 ranks) and dequantize once. Every rank gets the float32
    sum, shaped as ``x``."""
    blocks = _blocks(x)
    scale = _scale(blocks)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
    return _dequant(qsum, scale, x.shape)


def bytes_saved(grads) -> Tuple[int, int]:
    """(float32 bytes, int8 bytes with the scales) of ``grads``."""
    if isinstance(grads, Mapping):
        grads = list(grads.values())
    n = sum(g.numel() for g in grads)
    return n * 4, n * 1 + (n // BLOCK + 1) * 4
