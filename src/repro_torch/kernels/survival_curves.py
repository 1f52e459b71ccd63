"""Wrappers of the batched survival-curve kernels, the scoring hot path:
``survival_curves`` (``csrc/survival_curves.cu``) for a single baseline and
``survival_curves_stratified`` (``csrc/survival_curves_stratified.cu``) for
a baseline per request. Both are the panel of ``csrc/curves.cuh``, whose
header says what bounds it on the card and how the design answers.

They replace the Pallas TPU kernels ``survival_curves`` and
``survival_curves_stratified`` of ``repro/kernels/survival_curves.py``.

The launch is planned here (``plan``), as a pure function of the shape and
the card's SM count, and handed to the launcher, which refuses a plan that
does not fit the shape.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build, ref

Tensor = torch.Tensor

# kernel launches in one such call, and no other device operation
KERNELS_PER_CALL = 1

# as csrc/curves.cuh has them
WARPS = 4                       # warps a block (kWarps)
SLAB_MAX = 32                   # rows of one eta load, lane i row i (kSlabMax)
# most strata a table may have to be staged in shared memory
# (kStagedStrata); a larger one is read through the read-only path
STAGED_STRATA = 8
# blocks an SM the plan fills before a warp takes more rows (of 1, 2, 4
# and 8, the fastest at b = 4,096 on an H100: scripts/ab_curves.py)
BLOCKS_PER_SM = 2


class Plan(NamedTuple):
    blocks: int    # blocks a column chunk (grid x)
    slab: int      # rows a warp writes per eta load, <= SLAB_MAX
    vec: int       # columns a lane stores at once: 4 (16 bytes) or 1
    chunks: int    # column chunks of a row, 32 * vec columns each (grid y)
    tail: int      # columns of the last chunk
    staged: bool   # the stratified table staged in shared memory


@functools.lru_cache(maxsize=1024)
def plan(b: int, g: int, sms: int, s: int = 1, stratified: bool = False,
         aligned: bool = True, blocks_per_sm: int = BLOCKS_PER_SM) -> Plan:
    """Launch plan of a (b, g) panel on a card of ``sms`` SMs.

    ``s`` is a stratified table's row count; a table of at most
    STAGED_STRATA strata is staged in shared memory. ``aligned`` says that
    the baseline lies on 16 bytes, so rows of g % 4 == 0 columns take
    16-byte accesses. The card's resident warps,
    ``sms x blocks_per_sm x WARPS``, are shared among the column chunks;
    each warp takes a slab of rows, as few as spread the batch over those
    warps (at most SLAB_MAX), and walks on by the grid's stride when the
    batch is larger still."""
    if b < 1 or g < 1 or s < 1 or sms < 1 or blocks_per_sm < 1:
        raise ValueError(f"plan: b={b}, g={g}, s={s}, sms={sms}, "
                         f"blocks_per_sm={blocks_per_sm}")
    vec = 4 if g % 4 == 0 and aligned else 1
    chunk = 32 * vec
    chunks = -(-g // chunk)
    tail = g - (chunks - 1) * chunk
    warps = max(WARPS, sms * blocks_per_sm * WARPS // chunks)
    slab = min(SLAB_MAX, -(-b // warps))
    blocks = min(-(-b // (slab * WARPS)), warps // WARPS)
    return Plan(blocks, slab, vec, chunks, tail,
                stratified and s <= STAGED_STRATA)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def survival_curves(eta: Tensor, h0: Tensor) -> Tensor:
    """(b, g) S = exp(-h0[g] * exp(clip(eta[b], -30, 30))).

    eta: (b,) linear predictors; h0: (g,) cumulative baseline hazard, both
    float32 on a card, where the call is one kernel launch and nothing
    else. On the CPU the plain version runs."""
    if eta.dim() != 1 or h0.dim() != 1:
        raise ValueError(f"survival_curves: eta and h0 must be vectors, got "
                         f"{tuple(eta.shape)} and {tuple(h0.shape)}")
    b, g = eta.shape[0], h0.shape[0]
    on_card = _build.require(
        "survival_curves", {"eta": eta, "h0": h0},
        {"eta": (b,), "h0": (g,)},
        {"eta": torch.float32, "h0": torch.float32})
    if not on_card:
        return ref.survival_curves_ref(eta, h0)
    out = torch.empty((b, g), dtype=torch.float32, device=eta.device)
    if b == 0 or g == 0:
        return out
    pl = plan(b, g, _sms(eta.device), aligned=h0.data_ptr() % 16 == 0)
    lib = _build.library()
    _build.check(lib.repro_survival_curves(
        eta.data_ptr(), h0.data_ptr(), b, g, pl.blocks, pl.slab, pl.vec,
        pl.tail, out.data_ptr(), _build.stream()), "survival_curves")
    _build.LAUNCHES.add("survival_curves")
    return out


def survival_curves_stratified(eta: Tensor, h0: Tensor,
                               strata: Tensor) -> Tensor:
    """(b, g) S = exp(-h0[strata[b], g] * exp(clip(eta[b], -30, 30))).

    eta: (b,) linear predictors; h0: (s, g) cumulative baseline hazard per
    stratum; strata: (b,) row indices into h0. On a card eta and h0 are
    float32 and strata int32, strata must lie in [0, s) (the kernel does
    not check them on the device), and the call is one kernel launch and
    nothing else. On the CPU the plain version runs."""
    if eta.dim() != 1 or h0.dim() != 2:
        raise ValueError(f"survival_curves_stratified: eta must be a vector "
                         f"and h0 an (s, g) table, got {tuple(eta.shape)} "
                         f"and {tuple(h0.shape)}")
    b, (s, g) = eta.shape[0], h0.shape
    on_card = _build.require(
        "survival_curves_stratified",
        {"eta": eta, "h0": h0, "strata": strata},
        {"eta": (b,), "h0": (s, g), "strata": (b,)},
        {"eta": torch.float32, "h0": torch.float32, "strata": torch.int32})
    if not on_card:
        return ref.survival_curves_stratified_ref(eta, h0, strata)
    out = torch.empty((b, g), dtype=torch.float32, device=eta.device)
    if b == 0 or g == 0:
        return out
    pl = plan(b, g, _sms(eta.device), s, stratified=True,
              aligned=h0.data_ptr() % 16 == 0)
    lib = _build.library()
    _build.check(lib.repro_survival_curves_stratified(
        eta.data_ptr(), h0.data_ptr(), strata.data_ptr(), b, g, s, pl.blocks,
        pl.slab, pl.vec, pl.tail, int(pl.staged), out.data_ptr(),
        _build.stream()), "survival_curves_stratified")
    _build.LAUNCHES.add("survival_curves_stratified")
    return out
