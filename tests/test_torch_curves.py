"""The launch plan and the row walk of the survival-curve kernels
(``csrc/curves.cuh``), modelled in NumPy and held against the JAX package.

Both curve kernels are one panel: a fixed number of blocks whose warps each
take a slab of up to 32 rows and walk on by the grid's stride, columns cut
into chunks of 32 x vec (vec = 4, a 16-byte store a lane, when g % 4 == 0),
exp(clip(eta)) formed once a row by the lane that loaded it and handed out
by a shuffle, the single baseline held per lane across its rows, a
stratified table of up to 8 strata staged in shared memory once a block
and a larger one read a row at a time through the read-only path. The CUDA
kernels need a card; this file checks here on the CPU that the plan
(``kernels/survival_curves.py::plan``) covers every (row, column) exactly
once, and that the walk, followed step by step in float32, computes the
Pallas kernels' function (interpret mode; rtol 1e-5 / atol 1e-6 for the
single baseline and rtol 1e-6 / atol 1e-6 for the stratified curves, as
tests/test_torch_kernels.py holds the plain versions).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.survival_curves import \
    survival_curves as j_survival_curves  # noqa: E402
from repro.kernels.survival_curves import \
    survival_curves_stratified as j_curves_strat  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import survival_curves as curves_mod  # noqa: E402
from repro_torch.kernels.survival_curves import plan  # noqa: E402

SMS = 132          # an H100 SXM's SMs
CLIP = 30.0
BS = (1, 2, 37, 64, 4096, 4097)
GS = (1, 3, 4, 5, 127, 128, 129, 257)


def _warps(pl, b):
    """(chunk, the first rows of the warp's slabs) of every warp of the
    grid, in the kernel's order: warp w of block x starts at
    (x * WARPS + w) * slab and steps by blocks * WARPS * slab."""
    warps = curves_mod.WARPS
    stride = pl.blocks * warps * pl.slab
    for cy in range(pl.chunks):
        for bx in range(pl.blocks):
            for w in range(warps):
                yield cy, range((bx * warps + w) * pl.slab, b, stride)


def _slabs(pl, b):
    """(chunk, first row, rows) of every slab the grid's warps take."""
    for cy, starts in _warps(pl, b):
        for r0 in starts:
            yield cy, r0, min(pl.slab, b - r0)


def _lanes(pl, cy):
    """(lanes that hold columns, their first columns, the chunk's width)."""
    chunk = 32 * pl.vec
    width = pl.tail if cy == pl.chunks - 1 else chunk
    lanes = np.arange(32)
    lanes = lanes[lanes * pl.vec < width]
    return lanes, cy * chunk + lanes * pl.vec, width


@pytest.mark.parametrize("g", GS)
@pytest.mark.parametrize("b", BS)
def test_plan_covers_every_element_once(b, g):
    pl = plan(b, g, SMS)
    chunk = 32 * pl.vec
    assert pl.vec == (4 if g % 4 == 0 else 1)
    assert pl.chunks == -(-g // chunk) and 1 <= pl.tail <= chunk
    assert pl.tail == g - (pl.chunks - 1) * chunk
    assert 1 <= pl.slab <= curves_mod.SLAB_MAX and pl.blocks >= 1
    # no more blocks than the card's share of a chunk, nor than the rows
    assert pl.blocks <= max(1, SMS * curves_mod.BLOCKS_PER_SM // pl.chunks)
    assert (pl.blocks - 1) * curves_mod.WARPS * pl.slab < b
    hits = np.zeros((b, g), np.int32)
    for cy, r0, rows in _slabs(pl, b):
        _, first, width = _lanes(pl, cy)
        assert width % pl.vec == 0
        cols = (first[:, None] + np.arange(pl.vec)).ravel()
        assert cols.max() < g
        rr = r0 + np.arange(rows)    # row i of a slab is lane i's
        if pl.vec == 4:          # 16-byte stores: every address on 16 bytes
            assert np.all((rr[:, None] * g + first[None, :]) % 4 == 0)
        np.add.at(hits, (rr[:, None], cols[None, :]), 1)
    assert np.all(hits == 1)


def _model(eta, h0, strata, pl, stats):
    """The kernel's walk in float32: (b, g) S from eta (b,), the (s, g)
    table h0 and strata (b,) (None for a single baseline, s = 1)."""
    b, g = eta.shape[0], h0.shape[1]
    out = np.full((b, g), np.nan, np.float32)
    for cy in range(pl.chunks):
        lanes, first, width = _lanes(pl, cy)
        cols = first[:, None] + np.arange(pl.vec)        # (lanes, vec)
        c0 = cy * 32 * pl.vec
        if pl.staged:            # once a block: 32 slots a stratum
            s = h0.shape[0]
            table = np.zeros((s, 32 * pl.vec), np.float32)
            table[:, :width] = h0[:, c0:c0 + width]
            stats["h0_reads"] += pl.blocks * s * width
        for _, starts in (w for w in _warps(pl, b) if w[0] == cy):
            if strata is None:   # a lane's columns, in registers
                held = h0[0, cols]
                stats["h0_reads"] += held.size
            for r0 in starts:
                rows = min(pl.slab, b - r0)
                # lane i loads row r0 + i; its factor is formed once
                risk = np.exp(np.clip(eta[r0:r0 + rows], -CLIP, CLIP))
                stats["risk"] += rows
                for row in range(rows):     # shuffled from lane `row`
                    rk = risk[row]
                    if strata is None:
                        v = held
                    elif pl.staged:   # the stratum's slots of the table
                        v = table[strata[r0 + row],
                                  lanes[:, None] * pl.vec + np.arange(pl.vec)]
                    else:        # the stratum's columns, read-only path
                        v = h0[strata[r0 + row], cols]
                        stats["h0_reads"] += v.size
                    out[r0 + row, cols] = np.exp(-(v * rk))
                    stats["exp"] += v.size
    return out


def _inputs(b, s, g, seed):
    rng = np.random.default_rng(seed)
    eta = (rng.standard_normal(b) * 3.0).astype(np.float32)
    eta[0] = 100.0
    if b > 1:
        eta[1] = -100.0
    if b > 3:
        eta[2:4] = (50.0, -50.0)
        wide = rng.uniform(size=b - 4) < 0.1
        eta[4:][wide] = rng.uniform(-100, 100, int(wide.sum()))
    h0 = np.cumsum(rng.uniform(0, 0.05, (s, g)), axis=1).astype(np.float32)
    strata = rng.integers(0, s, b).astype(np.int32)
    return eta, h0, strata


CASES = [(1, 1, SMS), (2, 3, SMS), (37, 5, SMS), (64, 129, SMS),
         (130, 128, SMS), (130, 257, SMS), (37, 5, 1), (130, 128, 1),
         (700, 128, 1), (700, 257, 1)]


@pytest.mark.parametrize("b,g,sms", CASES)
def test_walk_single_baseline_matches_pallas(b, g, sms):
    eta, h0, _ = _inputs(b, 1, g, b * 7 + g)
    pl = plan(b, g, sms)
    stats = dict.fromkeys(("risk", "exp", "h0_reads"), 0)
    got = _model(eta, h0, None, pl, stats)
    want = j_survival_curves(jnp.asarray(eta), jnp.asarray(h0[0]),
                             block_b=128, block_g=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    # exp(clip(eta)) once a row of each chunk, one exp an element, and
    # H0 read once a warp, however many rows the warp walks
    assert stats["risk"] == b * pl.chunks and stats["exp"] == b * g
    assert stats["h0_reads"] == pl.blocks * curves_mod.WARPS * g
    slabs = sum(1 for _ in _slabs(pl, b))
    assert slabs == -(-b // pl.slab) * pl.chunks
    if b >= 700:              # more slabs than warps: the stride walk
        assert slabs > pl.blocks * curves_mod.WARPS * pl.chunks


@pytest.mark.parametrize("b,g", [(37, 5), (130, 128), (64, 129)])
def test_walk_unaligned_baseline_takes_scalar_path(b, g):
    eta, h0, _ = _inputs(b, 1, g, 3)
    pl = plan(b, g, SMS, aligned=False)
    assert pl.vec == 1 and pl.tail == g - (pl.chunks - 1) * 32
    got = _model(eta, h0, None, pl, dict.fromkeys(("risk", "exp",
                                                   "h0_reads"), 0))
    want = j_survival_curves(jnp.asarray(eta), jnp.asarray(h0[0]),
                             interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("route", ["staged", "read-only"])
@pytest.mark.parametrize("b,s,g,sms", [(1, 1, 16, SMS), (37, 5, 257, SMS),
                                       (64, 3, 128, SMS), (130, 8, 129, SMS),
                                       (97, 8, 128, SMS), (700, 8, 128, 1),
                                       (130, 8, 257, SMS)])
def test_walk_stratified_matches_pallas(b, s, g, sms, route):
    eta, h0, strata = _inputs(b, s, g, b + s + g)
    pl = plan(b, g, sms, s, stratified=True)
    assert pl.staged          # at most 8 strata
    pl = pl._replace(staged=route == "staged")
    stats = dict.fromkeys(("risk", "exp", "h0_reads"), 0)
    got = _model(eta, h0, strata, pl, stats)
    want = j_curves_strat(jnp.asarray(eta), jnp.asarray(h0),
                          jnp.asarray(strata), block_g=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
    # one exp(clip(eta)) a row of each chunk and one exp an element; the
    # table read once a block when staged, else once an element
    assert stats["risk"] == b * pl.chunks and stats["exp"] == b * g
    assert stats["h0_reads"] == (pl.blocks * s * g if pl.staged else b * g)


@pytest.mark.parametrize("s,g", [(9, 128), (65, 128), (512, 257)])
def test_large_tables_take_the_read_only_path(s, g):
    b = 37
    pl = plan(b, g, SMS, s, stratified=True)
    assert s > curves_mod.STAGED_STRATA and not pl.staged
    eta, h0, strata = _inputs(b, s, g, s + g)
    got = _model(eta, h0, strata, pl, dict.fromkeys(("risk", "exp",
                                                     "h0_reads"), 0))
    want = j_curves_strat(jnp.asarray(eta), jnp.asarray(h0),
                          jnp.asarray(strata), interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


def test_plan_constants_match_the_header():
    text = (_build.CSRC / "curves.cuh").read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = ([0-9]+);", text)
        return int(m.group(1))
    assert const("kWarps") == curves_mod.WARPS
    assert const("kSlabMax") == curves_mod.SLAB_MAX
    assert const("kStagedStrata") == curves_mod.STAGED_STRATA
    for name in ("survival_curves.cu", "survival_curves_stratified.cu"):
        assert '#include "curves.cuh"' in (_build.CSRC / name).read_text()


def test_plan_spreads_the_scoring_batches_over_the_card():
    # b = 4,096, g = 128: one chunk, every block of the plan's share
    # resident at once, a few rows a warp
    pl = plan(4096, 128, SMS)
    assert (pl.vec, pl.chunks, pl.tail) == (4, 1, 128)
    assert pl.blocks <= SMS * curves_mod.BLOCKS_PER_SM
    assert pl.blocks * curves_mod.WARPS * pl.slab >= 4096
    # a batch beyond one pass of the card's warps walks by the stride
    big = plan(1_000_000, 128, SMS)
    assert big.slab == curves_mod.SLAB_MAX
    assert big.blocks == SMS * curves_mod.BLOCKS_PER_SM
    assert plan(1, 128, SMS) == (1, 1, 4, 1, 128, False)
    assert plan(1, 128, SMS, 8, stratified=True).staged
    with pytest.raises(ValueError):
        plan(0, 128, SMS)
    with pytest.raises(ValueError):
        plan(4, 128, SMS, s=0, stratified=True)
