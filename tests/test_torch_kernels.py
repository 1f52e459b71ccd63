"""Port's kernel wrappers and plain versions against the JAX package.

The CUDA kernels need a card and nvcc; here every wrapper takes its plain
version, because its tensors lie on the CPU, and that plain version is held
against the JAX Pallas kernel (interpret mode, as tests/test_kernels.py runs
it) on tie-free data and against the JAX package's Breslow definitions in
core/cox.py on tied data. chip_smoke.py holds the kernels against the same
plain versions on the card.

Tolerances: float32 against the Pallas kernels, 2e-5 (g, h) and 2e-4 (c3,
a third moment) as in tests/test_kernels.py, 1e-4 for the Lipschitz
constants, 1e-5 for the curve panel, 1e-3 for the suffix scan and 1e-4 for
cox_batch (bfloat16 3e-2 and 5e-2: one bfloat16 rounding of outputs or
products), 1e-6 for the stratified curves; float64 against core/cox.py,
1e-8.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cox as jcox  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.cox_batch import cox_batch as j_cox_batch  # noqa: E402
from repro.kernels.cox_coord import cox_coord as j_cox_coord  # noqa: E402
from repro.kernels.revcumsum import revcumsum as j_revcumsum  # noqa: E402
from repro.kernels.survival_curves import \
    survival_curves as j_survival_curves  # noqa: E402
from repro.kernels.survival_curves import \
    survival_curves_stratified as j_curves_strat  # noqa: E402
from repro_torch.core import cox  # noqa: E402
from repro_torch.data.synthetic import make_tied_survival  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.cox_batch import cox_batch  # noqa: E402
from repro_torch.kernels.cox_coord import cox_coord  # noqa: E402
from repro_torch.kernels.lipschitz import lipschitz  # noqa: E402
from repro_torch.kernels.revcumsum import revcumsum  # noqa: E402
from repro_torch.kernels.survival_curves import (  # noqa: E402
    survival_curves, survival_curves_stratified)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tie_free(n, m, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, m)).astype(np.float32)
    # distinct-by-construction times (f32 uniform draws collide at n=2000)
    t = rng.permutation(1.0 + np.arange(n) / n).astype(np.float32)
    delta = (rng.uniform(size=n) < 0.6).astype(np.float32)
    return x, t, delta


# ---------------------------------------------------------------------------
# cox_coord
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 64, 257, 1024, 2000])
@pytest.mark.parametrize("order", [2, 3])
def test_cox_coord_matches_pallas_tie_free(n, order):
    rng = np.random.default_rng(n + order)
    eta = (rng.standard_normal(n) * 0.8).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    d = (rng.uniform(size=n) < 0.7).astype(np.float32)
    want = j_cox_coord(jnp.asarray(eta), jnp.asarray(x), jnp.asarray(d),
                       order=order, block=128, interpret=True)
    got = cox_coord(_t(eta), _t(x), _t(d),
                    torch.arange(n, dtype=torch.int32), order=order)
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=2e-5, atol=2e-5)
    if order == 3:
        np.testing.assert_allclose(got[2], want[2], rtol=2e-4, atol=2e-4)
    else:
        assert float(got[2]) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("order", [2, 3])
def test_cox_coord_matches_breslow_on_ties(seed, order):
    x, t, delta = make_tied_survival(n=300, p=5, n_times=12, seed=seed)
    x = x.astype(np.float64)
    beta = np.random.default_rng(seed).standard_normal(5) * 0.4
    with jax.enable_x64(True):
        jd = jcox.prepare(x, t, delta)
        eta = jd.x @ jnp.asarray(beta)
        want = [np.asarray(jcox.coord_derivs(jd, eta, jd.x[:, l],
                                             order=order))
                for l in range(5)]
        eta_np = np.asarray(eta)
    td = cox.prepare(x, t, delta, device="cpu")
    assert not torch.equal(td.risk_start, torch.arange(300, dtype=torch.int32))
    for l in range(5):
        got = cox_coord(_t(eta_np), td.xT[l], td.delta, td.risk_start,
                        order=order)
        np.testing.assert_allclose(got.numpy(), want[l], rtol=1e-8,
                                   atol=1e-10)


def test_ops_cox_coord_entry_points():
    x, t, delta = make_tied_survival(n=120, p=3, seed=5)
    td = cox.prepare(x, t, delta, device="cpu")
    eta = td.x @ torch.tensor([0.3, -0.2, 0.1])
    g, h = ops.cox_coord_grad_hess(eta, td.xT[1], td.delta, td.risk_start)
    g3, h3, c3 = ops.cox_coord_all(eta, td.xT[1], td.delta, td.risk_start)
    want = cox.coord_derivs(td, eta, td.xT[1], order=3)
    for a, b in ((g, want[0]), (h, want[1]), (g3, want[0]), (h3, want[1]),
                 (c3, want[2])):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("order", [2, 3])
def test_cox_coord_candidate_rows_are_single_calls(order):
    """A (C, n) call's rows are the calls on each row's eta and column."""
    x, t, delta = make_tied_survival(n=300, p=6, n_times=20, seed=4)
    td = cox.prepare(x, t, delta, device="cpu")
    groups = ops.group_events(td.delta, td.risk_start)
    eta = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (6, 300)).astype(np.float32))
    got = cox_coord(eta, td.xT, td.delta, td.risk_start, order, groups)
    assert got.shape == (6, 3)
    for r in range(6):
        assert torch.equal(got[r], cox_coord(eta[r], td.xT[r], td.delta,
                                             td.risk_start, order, groups))
    with pytest.raises(ValueError):
        cox_coord(eta, td.xT[:5], td.delta, td.risk_start, order, groups)


def _step_data(kind):
    x, t, delta = make_tied_survival(n=200, p=12, n_times=15, seed=8)
    if kind == "tie_free":
        t = t + np.arange(200, dtype=np.float32) * 1e-3
    td = cox.prepare(x, t, delta, device="cpu")
    tie_free = torch.equal(td.risk_start, torch.arange(200, dtype=torch.int32))
    assert tie_free == (kind == "tie_free")
    return td


@pytest.mark.parametrize("kind", ["tied", "tie_free"])
def test_coord_step_is_each_candidates_eager_step(kind):
    """``solvers.coord_step`` over C candidates on the CPU (the fused
    step's plain version) against the eager finetune step of each
    candidate alone (``finetune``'s loop before batching), bit for bit:
    the pending eta update, (g, h) and the surrogate step."""
    from repro_torch.core import solvers, surrogate

    td = _step_data(kind)
    groups = ops.group_events(td.delta, td.risk_start)
    cols = torch.tensor([[0, 4, 9], [2, 4, 11], [1, 3, 5]])
    rows, lam2 = td.xT[cols], 1e-3
    curv = cox.lipschitz_constants(td)[0][cols] + 2.0 * lam2
    eta, beta = torch.zeros(3, 200), torch.zeros(3, 3)
    step = torch.zeros(3)
    want_eta, want_beta = torch.zeros(3, 200), torch.zeros(3, 3)
    prev = None
    for _ in range(3):
        for j in range(3):
            solvers.coord_step(td, eta, rows, j, prev, beta, curv, step,
                               groups, lam2)
            prev = j
            for r in range(3):
                g, _ = solvers.coord_grad_hess(td, want_eta[r], rows[r, j],
                                               groups)
                d = surrogate.quad_min(g + 2.0 * lam2 * want_beta[r, j],
                                       curv[r, j])
                want_beta[r, j].add_(d)
                want_eta[r].addcmul_(rows[r, j], d)
                assert torch.equal(step[r], d)
            assert torch.equal(beta, want_beta)
    eta.addcmul_(rows[:, prev], step[:, None])
    assert torch.equal(eta, want_eta)


def test_cox_coord_step_validates_and_needs_a_card():
    n, c, s = 40, 4, 2
    eta, rows = torch.zeros(c, n), torch.ones(c, s, n)
    beta, curv, step = torch.zeros(c, s), torch.ones(c, s), torch.zeros(c)
    d = torch.ones(n)
    with pytest.raises(ValueError, match="card"):
        ops.cox_coord_step(eta, rows, 1, 0, beta, curv, step, d, d, 1e-3)
    with pytest.raises(ValueError, match="columns"):
        ops.cox_coord_step(eta, rows, s, 0, beta, curv, step, d, d, 1e-3)
    with pytest.raises(ValueError, match="shape"):
        ops.cox_coord_step(eta, rows, 0, None, beta[:, :1], curv, step, d,
                           d, 1e-3)
    with pytest.raises(ValueError, match="shape"):
        ops.cox_coord_step(eta[:, :-1], rows, 0, None, beta, curv, step, d,
                           d, 1e-3)


def _tied_layout(layout, seed):
    """make_tied_survival data (n=300, p=5) in float64, with its times as
    drawn ("grid"), with the latest quarter of the rows in one tie group
    ("quarter"), or with every row in one group ("all")."""
    x, t, delta = make_tied_survival(n=300, p=5, n_times=12, seed=seed)
    if layout == "quarter":
        t[np.argsort(t, kind="stable")[-75:]] = t.max() + 1.0
    elif layout == "all":
        t[:] = 1.0
    return x.astype(np.float64), t, delta


@pytest.mark.parametrize("layout", ["grid", "quarter", "all"])
@pytest.mark.parametrize("order", [2, 3])
def test_cox_coord_group_form_matches_breslow(layout, order):
    """The group-start form (the plain path given group_events) against
    JAX cox.coord_derivs on tied data."""
    x, t, delta = _tied_layout(layout, seed=3)
    beta = np.random.default_rng(4).standard_normal(5) * 0.4
    with jax.enable_x64(True):
        jd = jcox.prepare(x, t, delta)
        eta = jd.x @ jnp.asarray(beta)
        want = [np.asarray(jcox.coord_derivs(jd, eta, jd.x[:, l],
                                             order=order))
                for l in range(5)]
        eta_np = np.asarray(eta)
    td = cox.prepare(x, t, delta, device="cpu")
    groups = ops.group_events(td.delta, td.risk_start)
    starts = td.risk_start.long() == torch.arange(300)
    assert groups.dtype == torch.float64
    assert torch.all(groups[~starts] == 0)
    assert float(groups.sum()) == float(td.delta.sum())
    if layout == "all":
        assert float(groups[0]) == float(td.delta.sum())
    for l in range(5):
        got = cox_coord(_t(eta_np), td.xT[l], td.delta, td.risk_start,
                        order=order, group_events=groups)
        np.testing.assert_allclose(got.numpy(), want[l], rtol=1e-8,
                                   atol=1e-10)


@pytest.mark.parametrize("layout", ["grid", "quarter", "all"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ops_cox_coord_with_and_without_group_events(layout, dtype):
    x, t, delta = _tied_layout(layout, seed=6)
    td = cox.prepare(x.astype(dtype), t, delta, device="cpu")
    eta = td.x @ torch.tensor([0.3, -0.2, 0.1, 0.0, 0.25],
                              dtype=getattr(torch, dtype))
    groups = ops.group_events(td.delta, td.risk_start)
    tol = 1e-8 if dtype == "float64" else 2e-5
    for l in range(5):
        args = (eta, td.xT[l], td.delta, td.risk_start)
        for with_, without in (
                (ops.cox_coord_grad_hess(*args, groups),
                 ops.cox_coord_grad_hess(*args)),
                (ops.cox_coord_all(*args, groups), ops.cox_coord_all(*args))):
            for a, b in zip(with_, without):
                assert a.dtype == getattr(torch, dtype)
                np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# lipschitz
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m", [(1, 1), (50, 4), (513, 8), (2000, 16)])
def test_lipschitz_matches_pallas_tie_free(n, m):
    x, t, delta = _tie_free(n, m, seed=n + m)
    with jax.enable_x64(False):
        jd = jcox.prepare(x, t, delta)
        l2_w, l3_w = jops.lipschitz_constants(jd.x, jd.delta, block_n=256)
    td = cox.prepare(x, t, delta, device="cpu")
    l2, l3 = lipschitz(td.x, td.delta, td.risk_start)
    np.testing.assert_allclose(l2, l2_w, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(l3, l3_w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shared_groups", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lipschitz_matches_breslow_on_ties(seed, shared_groups):
    """Both plain forms against JAX: at each sample's risk_start, and at
    the group starts with the fit's shared group counts (what the kernel
    computes)."""
    x, t, delta = make_tied_survival(n=400, p=7, n_times=10, seed=seed)
    x = x.astype(np.float64)
    with jax.enable_x64(True):
        want = [np.asarray(v) for v in
                jcox.lipschitz_constants(jcox.prepare(x, t, delta))]
    td = cox.prepare(x, t, delta, device="cpu")
    groups = (ops.group_events(td.delta, td.risk_start) if shared_groups
              else None)
    got = ops.lipschitz_constants(td.x, td.delta, td.risk_start, groups)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-8, atol=1e-12)


# ---------------------------------------------------------------------------
# survival_curves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,g", [(1, 1), (7, 33), (256, 128), (300, 130)])
def test_survival_curves_matches_pallas(b, g):
    rng = np.random.default_rng(b + g)
    eta = (rng.standard_normal(b) * 2.0).astype(np.float32)
    h0 = np.sort(rng.uniform(0, 3, g)).astype(np.float32)
    want = j_survival_curves(jnp.asarray(eta), jnp.asarray(h0), block_b=128,
                             block_g=64, interpret=True)
    got = survival_curves(_t(eta), _t(h0))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_survival_curves_extreme_eta_saturates():
    eta = torch.tensor([-80.0, 80.0, -50.0, 50.0])
    h0 = torch.tensor([0.5, 1.0])
    out = ops.survival_curves(eta, h0)
    assert torch.all(torch.isfinite(out))
    np.testing.assert_allclose(out[0], 1.0, atol=1e-6)   # ~zero risk
    np.testing.assert_allclose(out[1], 0.0, atol=1e-6)   # huge risk
    want = jref.survival_curves_ref(jnp.asarray(eta.numpy()),
                                    jnp.asarray(h0.numpy()))
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# revcumsum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 3, 128])
@pytest.mark.parametrize("n", [1, 7, 128, 513, 1000, 4096])
def test_revcumsum_matches_pallas(n, m, dtype):
    x32 = np.random.default_rng(n + m).standard_normal((n, m)).astype(
        np.float32)
    jx = jnp.asarray(x32, dtype=getattr(jnp, dtype))
    want = j_revcumsum(jx, block_n=256, interpret=True)
    tx = torch.from_numpy(x32).to(getattr(torch, dtype))
    got = ops.revcumsum(tx)
    assert got.dtype == tx.dtype and got.shape == (n, m)
    tol = 1e-3 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_revcumsum_vector_matches_jax_ops():
    x = np.random.default_rng(9).standard_normal(777).astype(np.float32)
    want = jops.revcumsum(jnp.asarray(x))
    got = revcumsum(_t(x))
    assert got.shape == (777,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # float64 stays float64 (the reference's oracle rounds to float32)
    want64 = np.cumsum(x.astype(np.float64)[::-1])[::-1]
    got64 = revcumsum(_t(x.astype(np.float64)))
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), want64, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [8, 9, 31, 32, 33, 1001])
def test_revcumsum_matches_jax_plain_route(m, dtype):
    """Widths on both sides of the kernel's panel/vector split (32 columns)
    and of its 8- and 16-column strips, against the JAX package's plain
    route (kernels/ref.py::revcumsum_ref)."""
    n = 300
    x32 = np.random.default_rng(m).standard_normal((n, m)).astype(np.float32)
    with jax.enable_x64(False):
        want = jref.revcumsum_ref(jnp.asarray(x32, dtype=getattr(jnp, dtype)))
    tx = torch.from_numpy(x32).to(getattr(torch, dtype))
    got = ops.revcumsum(tx)
    assert got.dtype == tx.dtype and got.shape == (n, m)
    tol = 1e-3 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# cox_batch
# ---------------------------------------------------------------------------

def _batch_vectors(n, seed):
    """(w, r, wa, delta, inv_s0) as ops.cox_batch_grad_hess forms them."""
    rng = np.random.default_rng(seed)
    eta = (rng.standard_normal(n) * 0.5).astype(np.float32)
    d = (rng.uniform(size=n) < 0.7).astype(np.float32)
    w = np.exp(eta - eta.max())
    inv_s0 = (1.0 / np.cumsum(w[::-1])[::-1]).astype(np.float32)
    wa = (w * np.cumsum(d * inv_s0)).astype(np.float32)
    return eta, [w.astype(np.float32), (wa - d).astype(np.float32), wa, d,
                 inv_s0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,p", [(64, 8), (500, 33), (1024, 256), (2050, 70)])
def test_cox_batch_matches_pallas(n, p, dtype):
    x32 = np.random.default_rng(n + p).standard_normal((n, p)).astype(
        np.float32)
    _, vecs = _batch_vectors(n, seed=n * p)
    want = j_cox_batch(jnp.asarray(x32, dtype=getattr(jnp, dtype)),
                       *(jnp.asarray(v) for v in vecs), block_n=256,
                       block_p=128, interpret=True)
    got = cox_batch(torch.from_numpy(x32).to(getattr(torch, dtype)),
                    *(_t(v) for v in vecs))
    tol = 1e-4 if dtype == "float32" else 5e-2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (p,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol * 10)


def test_ops_cox_batch_grad_hess_matches_jax_and_core():
    x, t, delta = _tie_free(400, 12, seed=0)
    beta = (np.random.default_rng(1).standard_normal(12) * 0.3).astype(
        np.float32)
    with jax.enable_x64(False):
        jd = jcox.prepare(x, t, delta)
        want = jops.cox_batch_grad_hess(jd.x @ jnp.asarray(beta), jd.x,
                                        jd.delta)
    td = cox.prepare(x, t, delta, device="cpu")
    eta = td.x @ torch.from_numpy(beta)
    got = ops.cox_batch_grad_hess(eta, td.x, td.delta)
    core = cox.grad_hess_all(td, eta)
    for g, w, c in zip(got, want, core):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(g, c, rtol=2e-4, atol=2e-4)
    # float64 stays float64 through the plain route
    td64 = cox.prepare(x.astype(np.float64), t, delta, device="cpu")
    eta64 = td64.x @ torch.from_numpy(beta.astype(np.float64))
    for g, c in zip(ops.cox_batch_grad_hess(eta64, td64.x, td64.delta),
                    cox.grad_hess_all(td64, eta64)):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=1e-9,
                                   atol=1e-9)


# ---------------------------------------------------------------------------
# survival_curves_stratified
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,g", [(1, 1, 16), (37, 5, 200), (64, 3, 128),
                                   (130, 8, 257)])
def test_survival_curves_stratified_matches_pallas(b, s, g):
    rng = np.random.default_rng(b + s + g)
    eta = rng.standard_normal(b).astype(np.float32)
    h0 = np.cumsum(rng.uniform(0, 0.05, (s, g)), axis=1).astype(np.float32)
    strata = rng.integers(0, s, b).astype(np.int32)
    want = j_curves_strat(jnp.asarray(eta), jnp.asarray(h0),
                          jnp.asarray(strata), block_g=128, interpret=True)
    got = ops.survival_curves_stratified(_t(eta), _t(h0), _t(strata))
    assert got.shape == (b, g) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_survival_curves_stratified_clips_extreme_eta():
    eta = torch.tensor([100.0, -100.0, 50.0, -50.0])
    h0 = torch.stack([torch.linspace(0.0, 2.0, 32),
                      torch.linspace(0.0, 1.0, 32)])
    strata = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    got = survival_curves_stratified(eta, h0, strata)
    want = j_curves_strat(jnp.asarray(eta.numpy()), jnp.asarray(h0.numpy()),
                          jnp.asarray(strata.numpy()), interpret=True)
    assert torch.all(torch.isfinite(got))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # one stratum equals the unstratified panel
    one = survival_curves_stratified(eta, h0[:1], torch.zeros(4, dtype=torch.int32))
    np.testing.assert_array_equal(one, survival_curves(eta, h0[0]))


# ---------------------------------------------------------------------------
# The six oracles mirror the JAX package's kernels/ref.py
# ---------------------------------------------------------------------------

def _oracle_inputs():
    rng = np.random.default_rng(21)
    n, p, b, s, g = 200, 6, 9, 3, 17
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa
    eta, x, xm = f(n) * 0.5, f(n), f(n, p)
    d = (rng.uniform(size=n) < 0.7).astype(np.float32)
    w = np.exp(eta - eta.max())
    inv_s0 = (1.0 / np.cumsum(w[::-1])[::-1]).astype(np.float32)
    wa = (w * np.cumsum(d * inv_s0)).astype(np.float32)
    return {
        "revcumsum_ref": (xm,),
        "cox_coord_ref": (eta, x, d),
        "cox_batch_ref": (xm, w, wa - d, wa, d, inv_s0),
        "survival_curves_ref": (f(b), np.sort(rng.uniform(0, 2, g))
                                .astype(np.float32)),
        "survival_curves_stratified_ref": (
            f(b), np.cumsum(rng.uniform(0, 0.1, (s, g)), axis=1)
            .astype(np.float32), rng.integers(0, s, b).astype(np.int32)),
        "lipschitz_ref": (xm, d),
    }


@pytest.mark.parametrize("name", sorted(_oracle_inputs()))
def test_oracles_mirror_reference(name):
    args = _oracle_inputs()[name]
    with jax.enable_x64(False):
        want = getattr(jref, name)(*(jnp.asarray(a) for a in args))
    got = getattr(ref, name)(*(_t(np.asarray(a)) for a in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(np.asarray(g_, np.float32),
                                   np.asarray(w_, np.float32),
                                   rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# Wrapper contracts
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_plain_path_and_count_no_launch():
    ops.reset_launch_counts()
    counter = ops._M_DISPATCH
    before = counter.value(kernel="cox_coord", route="plain")
    x, t, delta = make_tied_survival(n=64, p=4, seed=2)
    td = cox.prepare(x, t, delta, device="cpu")
    eta = torch.zeros(64)
    ops.cox_coord_grad_hess(eta, td.xT[0], td.delta, td.risk_start)
    ops.lipschitz_constants(td.x, td.delta, td.risk_start)
    ops.survival_curves(eta[:5], torch.linspace(0, 1, 8))
    ops.revcumsum(td.x)
    ops.cox_batch_grad_hess(eta, td.x, td.delta)
    ops.survival_curves_stratified(eta[:5], torch.ones(2, 8),
                                   torch.zeros(5, dtype=torch.int32))
    assert ops.launch_counts() == dict.fromkeys(
        ("cox_coord", "lipschitz", "survival_curves", "revcumsum",
         "cox_batch", "survival_curves_stratified"), 0)
    assert counter.value(kernel="cox_coord", route="plain") == before + 1


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "order",
                                  "device", "empty"])
def test_wrappers_validate_arguments(case):
    n = 16
    eta, x, d = torch.zeros(n), torch.ones(n), torch.ones(n)
    rs = torch.arange(n, dtype=torch.int32)
    if case == "dtype":
        with pytest.raises(TypeError):
            cox_coord(eta, x, d, rs.float())
        with pytest.raises(TypeError):
            survival_curves(torch.zeros(3, dtype=torch.int64), torch.ones(4))
    elif case == "shape":
        with pytest.raises(ValueError):
            cox_coord(eta, x[:-1], d, rs)
        with pytest.raises(ValueError):
            lipschitz(torch.ones(n, 3), d[:-2], rs)
    elif case == "contiguity":
        with pytest.raises(ValueError):
            lipschitz(torch.ones(3, n).T, d, rs)
    elif case == "order":
        with pytest.raises(ValueError):
            cox_coord(eta, x, d, rs, order=4)
    elif case == "device":
        with pytest.raises(ValueError, match="not supported"):
            cox_coord(eta.to("meta"), x.to("meta"), d.to("meta"),
                      rs.to("meta"))
    else:
        with pytest.raises(ValueError):
            cox_coord(eta[:0], x[:0], d[:0], rs[:0])


@pytest.mark.parametrize("case", ["dtype", "shape", "empty"])
def test_second_slice_wrappers_validate_arguments(case):
    n, p = 16, 4
    x, v = torch.ones(n, p), torch.ones(n)
    strata = torch.zeros(3, dtype=torch.int32)
    if case == "dtype":
        with pytest.raises(TypeError):
            revcumsum(torch.ones(n, dtype=torch.int32))
        with pytest.raises(TypeError):
            cox_batch(x, v, v, v, v, torch.ones(n, dtype=torch.int64))
        with pytest.raises(TypeError):
            survival_curves_stratified(torch.zeros(3), torch.ones(2, 5),
                                       strata.float())
    elif case == "shape":
        with pytest.raises(ValueError):
            revcumsum(torch.ones(2, 3, 4))
        with pytest.raises(ValueError):
            cox_batch(x, v, v, v[:-1], v, v)
        with pytest.raises(ValueError):
            survival_curves_stratified(torch.zeros(3), torch.ones(5),
                                       strata)
        with pytest.raises(ValueError):
            survival_curves_stratified(torch.zeros(4), torch.ones(2, 5),
                                       strata)
    else:
        with pytest.raises(ValueError):
            revcumsum(torch.ones(0, 3))
        with pytest.raises(ValueError):
            cox_batch(x[:, :0], v, v, v, v, v)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A failed build raises; nothing falls back."""
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.library()
    assert not (tmp_path / "kernels").exists()


def test_build_digest_covers_every_source():
    names = {p.name for p in _build.CSRC.glob("*.cu*")}
    assert {"cox_coord.cu", "lipschitz.cu", "survival_curves.cu",
            "revcumsum.cu", "cox_batch.cu", "survival_curves_stratified.cu",
            "common.cuh"} <= names
    assert set(_build._SIGNATURES) >= {
        "repro_cox_coord", "repro_lipschitz", "repro_survival_curves",
        "repro_revcumsum", "repro_cox_batch",
        "repro_survival_curves_stratified"}
    # every C entry point is defined in some source
    text = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    for name in _build._SIGNATURES:
        assert f" {name}(" in text, name
    assert _build._digest() == _build._digest()
