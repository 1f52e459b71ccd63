"""The strip-tile decomposition of the cox_batch and lipschitz kernels,
modelled in NumPy and held against the JAX package.

``csrc/cox_batch.cu`` and ``csrc/lipschitz.cu`` read X once, in tiles of
one segment of rows by one strip of 32 columns (``csrc/strip.cuh``). A
tile forms what needs no carry first (cox_batch's g = sum r x and
h1 = sum wa x^2), takes the carry from the later segments by one fixed
formula over the next 8 segments, walks its rows from the last, and
leaves per-(segment, column) partials that are summed in a fixed order.
The CUDA kernels need a card; this file checks, here on the CPU, that the
decomposition itself computes the function: the model below follows the
kernels step by step (runs of 32 rows, their sums in the working type,
the carry formula, float64 partials summed by the kernels' lanes and
groups of 32 segments). Nothing in the package imports it.

The model runs in float32, as the kernels do, against the Pallas kernels
in interpret mode (tolerances of tests/test_kernels.py: cox_batch 1e-4,
bfloat16 5e-2; lipschitz 1e-4), and in float64 against the JAX package's
definitions in core/cox.py (1e-8): cox_batch on tie-free data (its
contract), lipschitz on tied data through the tie groups' event counts.
"""
import numpy as np
import pytest

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cox as jcox  # noqa: E402
from repro.kernels.cox_batch import cox_batch as j_cox_batch  # noqa: E402
from repro.kernels.lipschitz import lipschitz as j_lipschitz  # noqa: E402

RUN = 32            # rows a thread holds (strip.cuh kRun)
STRIP = 32          # columns of a strip (kCols)
WINDOW = 8          # segments a carry reaches back in one step (kWindow)
SUPER = 32          # segments whose partials one block sums (kSuper)
LANES = 4           # lanes of that sum: 256 threads over 2 x 32 values
INV_6_SQRT3 = 1.0 / (6.0 * np.sqrt(3.0))

NS = (257, 2050, 4097)
PS = (1, 33, 70)


def _carry(agg, op, identity):
    """Per column, each segment's carry from the later ones by the kernels'
    formula: carry(s) = A(s+1) (+) ... (+) A(s+7) (+) P(s+8), terms past
    the last segment the identity, P(s) = carry(s) (+) A(s); segments are
    taken last first, as the ticket deals them."""
    nseg = agg.shape[0]
    carry, incl = np.empty_like(agg), np.empty_like(agg)
    ident = np.full(agg.shape[1:], identity, dtype=agg.dtype)
    for s in range(nseg - 1, -1, -1):
        c = ident
        for k in range(WINDOW, 0, -1):
            if s + k >= nseg:
                term = ident
            else:
                term = incl[s + k] if k == WINDOW else agg[s + k]
            c = op(c, term)
        carry[s] = c
        incl[s] = op(c, agg[s])
    return carry


def _sum_partials(parts):
    """(nseg, m) float64 partials summed per column as strip.cuh does: each
    group of SUPER segments by LANES strided lanes combined in order, then
    the groups the same way."""
    def lanes(rows):
        acc = [np.zeros(rows.shape[1:]) for _ in range(LANES)]
        for r in range(rows.shape[0]):
            acc[r % LANES] = acc[r % LANES] + rows[r]
        tot = np.zeros(rows.shape[1:])
        for a in acc:
            tot = tot + a
        return tot
    groups = np.stack([lanes(parts[g:g + SUPER])
                       for g in range(0, parts.shape[0], SUPER)])
    return lanes(groups)


def _runs(v, seg_rows):
    """(nseg, runs, RUN, ...) view of a zero-padded (nseg * seg_rows, ...)
    array."""
    return v.reshape(-1, seg_rows // RUN, RUN, *v.shape[1:])


def _pad_rows(v, rows):
    pad = [(0, rows - v.shape[0])] + [(0, 0)] * (v.ndim - 1)
    return np.pad(v, pad)


def cox_batch_tiles(x, w, r, wa, delta, inv_s0, wt, seg_rows):
    """(grad, hess) of the cox_batch kernel's tile scheme, in working type
    ``wt`` with float64 partials."""
    n, p = x.shape
    nseg = -(-n // seg_rows)
    rows = nseg * seg_rows
    x = _pad_rows(x.astype(wt), rows)
    vecs = [_pad_rows(v.astype(wt), rows) for v in (w, r, wa, delta, inv_s0)]
    grad, hess = np.zeros(p), np.zeros(p)
    for lo in range(0, p, STRIP):           # one strip at a time
        xs = _runs(x[:, lo:lo + STRIP], seg_rows)   # (nseg, G, RUN, c)
        ws, rs, was, ds, invs = (_runs(v, seg_rows)[..., None]
                                 for v in vecs)
        groups, cols = xs.shape[1], xs.shape[3]
        # before the carry: each run's sums, last row first
        acc = np.zeros((nseg, groups, cols), wt)
        g, h1 = np.zeros_like(acc), np.zeros_like(acc)
        for k in range(RUN - 1, -1, -1):
            xk = xs[:, :, k]
            acc = acc + ws[:, :, k] * xk
            g = g + rs[:, :, k] * xk
            h1 = h1 + was[:, :, k] * xk * xk
        later = np.zeros_like(acc)          # the later runs of the tile
        for q in range(groups - 1, 0, -1):
            later[:, :q] = later[:, :q] + acc[:, q:q + 1]
        total = later[:, 0] + acc[:, 0]
        carry = _carry(total, np.add, 0.0)
        # the walk
        s1 = carry[:, None] + later
        h2 = np.zeros_like(acc)
        for k in range(RUN - 1, -1, -1):
            s1 = s1 + ws[:, :, k] * xs[:, :, k]
            mean = s1 * invs[:, :, k]
            h2 = h2 + ds[:, :, k] * mean * mean
        pg = np.zeros((nseg, cols))
        ph = np.zeros((nseg, cols))
        for q in range(groups):             # the tile's runs, in float64
            pg = pg + g[:, q].astype(np.float64)
            ph = ph + (h1[:, q] - h2[:, q]).astype(np.float64)
        grad[lo:lo + cols] = _sum_partials(pg)
        hess[lo:lo + cols] = _sum_partials(ph)
    return grad, hess


def lipschitz_tiles(x, d, wt):
    """(L2, L3) of the lipschitz kernel's tile scheme from x and the tie
    groups' event counts d at their starts; range in ``wt``, sums in
    float64."""
    n, p = x.shape
    seg_rows = 256
    nseg = -(-n // seg_rows)
    rows = nseg * seg_rows
    x = x.astype(wt)
    valid = _runs(np.arange(rows) < n, seg_rows)[..., None]
    xs_all = _runs(_pad_rows(x, rows), seg_rows)
    ds = _runs(_pad_rows(d.astype(np.float64), rows), seg_rows)[..., None]
    l2, l3 = np.zeros(p), np.zeros(p)
    for lo in range(0, p, STRIP):
        xs = xs_all[..., lo:lo + STRIP]
        groups, cols = xs.shape[1], xs.shape[3]
        neg = np.full((nseg, groups, cols), -np.inf, wt)
        mx, mn = neg.copy(), -neg
        for k in range(RUN - 1, -1, -1):
            ok = valid[:, :, k]
            mx = np.where(ok, np.maximum(mx, xs[:, :, k]), mx)
            mn = np.where(ok, np.minimum(mn, xs[:, :, k]), mn)
        later_mx, later_mn = neg.copy(), -neg
        for q in range(groups - 1, 0, -1):
            later_mx[:, :q] = np.maximum(later_mx[:, :q], mx[:, q:q + 1])
            later_mn[:, :q] = np.minimum(later_mn[:, :q], mn[:, q:q + 1])
        cmx = _carry(np.maximum(later_mx[:, 0], mx[:, 0]), np.maximum,
                     -np.inf)
        cmn = _carry(np.minimum(later_mn[:, 0], mn[:, 0]), np.minimum,
                     np.inf)
        hi = np.maximum(cmx[:, None], later_mx)
        low = np.minimum(cmn[:, None], later_mn)
        a2, a3 = np.zeros(hi.shape), np.zeros(hi.shape)
        for k in range(RUN - 1, -1, -1):
            ok = valid[:, :, k]
            hi = np.where(ok, np.maximum(hi, xs[:, :, k]), hi)
            low = np.where(ok, np.minimum(low, xs[:, :, k]), low)
            rng = np.where(ok, hi - low, 0).astype(np.float64)
            dk = np.where(ok, ds[:, :, k], 0.0)
            a2 = a2 + np.where(dk != 0, dk * rng * rng, 0.0)
            a3 = a3 + np.where(dk != 0, dk * rng * rng * rng, 0.0)
        p2 = np.zeros((nseg, cols))
        p3 = np.zeros((nseg, cols))
        for q in range(groups):
            p2, p3 = p2 + a2[:, q], p3 + a3[:, q]
        l2[lo:lo + cols] = 0.25 * _sum_partials(p2)
        l3[lo:lo + cols] = INV_6_SQRT3 * _sum_partials(p3)
    return l2, l3


def _group_events(delta, risk_start):
    """D: the summed delta of the tie group that starts at each index, 0
    where no group starts."""
    d = np.zeros(len(delta))
    np.add.at(d, risk_start, delta.astype(np.float64))
    return d


def _batch_inputs(n, p, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, p)).astype(np.float32)
    eta = (rng.standard_normal(n) * 0.5).astype(np.float32)
    delta = (rng.uniform(size=n) < 0.7).astype(np.float32)
    return x, eta, delta


def _batch_vectors(eta, delta, dtype):
    """(w, r, wa, delta, inv_s0) as ops.cox_batch_grad_hess forms them."""
    eta, delta = eta.astype(dtype), delta.astype(dtype)
    w = np.exp(eta - eta.max())
    inv_s0 = 1.0 / np.cumsum(w[::-1])[::-1]
    wa = w * np.cumsum(delta * inv_s0)
    return [v.astype(dtype) for v in (w, wa - delta, wa, delta, inv_s0)]


# ---------------------------------------------------------------------------
# cox_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("n", NS)
def test_cox_batch_tiles_match_pallas(n, p, dtype):
    x, eta, delta = _batch_inputs(n, p, seed=n * p)
    vecs = _batch_vectors(eta, delta, np.float32)
    with jax.enable_x64(False):
        xj = jnp.asarray(x, dtype=getattr(jnp, dtype))
        want = j_cox_batch(xj, *(jnp.asarray(v) for v in vecs), block_n=256,
                           block_p=128, interpret=True)
    # the kernel reads bfloat16 x exactly and works in float32, on
    # 512-row segments (16 runs of 32)
    xk = np.asarray(xj.astype(jnp.float32))
    got = cox_batch_tiles(xk, *vecs, wt=np.float32,
                          seg_rows=256 if dtype == "float32" else 512)
    tol = 1e-4 if dtype == "float32" else 5e-2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("n", NS)
def test_cox_batch_tiles_match_core_float64(n, p):
    x, eta, delta = _batch_inputs(n, p, seed=n + p)
    # tie-free by construction: the times are the row order
    t = np.arange(n, 0, -1).astype(np.float64)
    with jax.enable_x64(True):
        data = jcox.prepare(x.astype(np.float64), t, delta)
        eta_s = data.x @ jnp.asarray(np.linspace(-0.3, 0.3, p))
        want = jcox.grad_hess_all(data, eta_s)
        xs, ds, es = (np.asarray(a) for a in (data.x, data.delta, eta_s))
    got = cox_batch_tiles(xs, *_batch_vectors(es, ds, np.float64),
                          wt=np.float64, seg_rows=256)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-8, atol=1e-8)


# ---------------------------------------------------------------------------
# lipschitz
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("n", NS)
def test_lipschitz_tiles_match_pallas(n, p):
    rng = np.random.default_rng(n * p + 1)
    x = rng.standard_normal((n, p)).astype(np.float32)
    delta = (rng.uniform(size=n) < 0.6).astype(np.float32)
    with jax.enable_x64(False):
        want = j_lipschitz(jnp.asarray(x), jnp.asarray(delta), block_n=256,
                           interpret=True)
    # tie-free: every row starts its own group, D = delta
    got = lipschitz_tiles(x, delta, wt=np.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ties", ["grid", "edges", "all"])
@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("n", NS)
def test_lipschitz_tiles_match_core_on_ties(n, p, ties):
    """Tied times: on a grid of ~n/40 values, in groups that straddle the
    256-row segment edges, or one time for every row."""
    rng = np.random.default_rng(n + 7 * p)
    x = rng.standard_normal((n, p))
    delta = (rng.uniform(size=n) < 0.6).astype(np.float64)
    if ties == "grid":
        t = rng.integers(0, max(n // 40, 1), n).astype(np.float64)
    elif ties == "edges":
        t = (np.arange(n) + 100) // 200 * 1.0   # a group every 200 rows
    else:
        t = np.zeros(n)
    with jax.enable_x64(True):
        data = jcox.prepare(x, t, delta)
        want = jcox.lipschitz_constants(data)
        xs, ds, rs = (np.asarray(a) for a in (data.x, data.delta,
                                              data.risk_start))
    got = lipschitz_tiles(xs, _group_events(ds, rs), wt=np.float64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-8, atol=1e-8)
