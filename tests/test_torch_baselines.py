"""Port's core/penalties.py and the rest of core/solvers.py (fit_newton,
fit_working_newton, fit_gd, fit_cd_penalized, SOLVERS): the reference's
own checks (tests/test_extensions.py's SCAD/MCP grid searches and support
recovery, tests/test_solvers.py's baseline checks, the KKT check of
tests/test_optimality_elastic.py) against the port, and parity with the
JAX package on the same numpy inputs in float64, within 1e-8 relative
(the packages sum in different orders)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import cox as jcox  # noqa: E402
from repro.core import penalties as jpen  # noqa: E402
from repro.core import solvers as jsolvers  # noqa: E402
from repro_torch.core import cox, path, penalties, solvers  # noqa: E402
from repro_torch.data.synthetic import (SyntheticSpec,  # noqa: E402
                                        make_correlated_survival,
                                        make_tied_survival)
from repro_torch.survival import metrics  # noqa: E402

F64 = torch.float64
RTOL = 1e-8


def _s(v):
    return torch.tensor(v, dtype=F64)


# ---------------------------------------------------------------------------
# SCAD / MCP proxes against a grid search
# ---------------------------------------------------------------------------

def _grid_min(fn, lo=-60.0, hi=60.0, n=240001):
    g = torch.linspace(lo, hi, n, dtype=F64)
    return g[torch.argmin(fn(g))]


def _penalized(value, a, b, c, lam, gamma):
    """d -> a d + 1/2 b d^2 + value(c + d), over a vector of d."""
    def obj(d):
        return (a * d + 0.5 * b * d ** 2
                + value(torch.atleast_1d(c + d), lam, gamma))
    return obj, torch.vmap(obj)


@settings(max_examples=30, deadline=None)
@given(st.floats(-10, 10), st.floats(1.0, 20.0), st.floats(-5, 5),
       st.floats(0.05, 2.0))
def test_mcp_prox_vs_grid(a, b, c, lam):
    obj, grid_obj = _penalized(penalties.mcp_value, a, b, c, lam, 3.0)
    step = penalties.mcp_prox(_s(a), _s(b), _s(c), _s(lam), 3.0)
    assert float(obj(step)) <= float(obj(_grid_min(grid_obj))) + 1e-4


@settings(max_examples=30, deadline=None)
@given(st.floats(-10, 10), st.floats(1.0, 20.0), st.floats(-5, 5),
       st.floats(0.05, 2.0))
def test_scad_prox_vs_grid(a, b, c, lam):
    obj, grid_obj = _penalized(penalties.scad_value, a, b, c, lam, 3.7)
    step = penalties.scad_prox(_s(a), _s(b), _s(c), _s(lam), 3.7)
    assert float(obj(step)) <= float(obj(_grid_min(grid_obj))) + 1e-4


@pytest.mark.parametrize("name", ["mcp", "scad"])
def test_penalties_match_jax(name):
    """prox and value on a grid of (a, b, c, lam) holding every branch,
    b below 1 included (the denominators' guard)."""
    rng = np.random.default_rng(len(name))
    gamma = 3.0 if name == "mcp" else 3.7
    a = rng.uniform(-10, 10, 600)
    b = np.concatenate([rng.uniform(1e-3, 1.0, 200),
                        rng.uniform(1.0, 20.0, 400)])
    c = rng.uniform(-5, 5, 600)
    c[::9] = 0.0
    lam = rng.uniform(0.05, 2.0, 600)
    with jax.enable_x64(True):
        want = np.asarray(jpen.PROX[name](*map(jnp.asarray, (a, b, c, lam)),
                                          gamma))
        want_v = [float(jpen.VALUE[name](jnp.asarray(c[i:i + 50]), lam[i],
                                         gamma)) for i in range(0, 600, 50)]
    got = penalties.PROX[name](*map(torch.as_tensor, (a, b, c, lam)), gamma)
    got_v = [float(penalties.VALUE[name](torch.as_tensor(c[i:i + 50]),
                                         lam[i], gamma))
             for i in range(0, 600, 50)]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(got_v, want_v, rtol=RTOL)
    # 0-d tensors and Python floats, as a CD sweep passes them
    one = penalties.PROX[name](_s(a[0]), b[0], _s(c[0]), lam[0], gamma)
    assert one.dtype == F64 and float(one) == pytest.approx(want[0],
                                                            rel=RTOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_scad_mcp_cd_recover_support(use_kernel):
    """Nonconvex-penalty CD on correlated data: with lam scaled to the
    problem (0.4 * lambda_max), SCAD/MCP recover a near-true sparse
    support with monotone objective decrease."""
    x, t, delta, beta_star = make_correlated_survival(
        SyntheticSpec(n=500, p=60, k=5, rho=0.6, seed=4, censor_scale=3.0))
    data = cox.prepare(x.astype(np.float64), t, delta, device="cpu")
    lam = 0.4 * path.lambda_max(data)
    for pen in ("scad", "mcp"):
        res = solvers.fit_cd_penalized(data, penalty=pen, lam1=lam,
                                       n_iters=200, use_kernel=use_kernel,
                                       device="cpu")
        obj = res.objective.numpy()
        assert np.all(np.isfinite(obj))
        assert np.all(np.diff(obj) <= 1e-6 * abs(obj[0])), pen
        b = res.beta.numpy()
        nnz = int((np.abs(b) > 1e-8).sum())
        _, _, f1 = metrics.support_f1(beta_star, b)
        assert nnz <= 12, (pen, nnz)
        assert f1 >= 0.8, (pen, f1)


# ---------------------------------------------------------------------------
# The Section-2 baselines (tests/test_solvers.py)
# ---------------------------------------------------------------------------

def _problem_arrays():
    x, t, delta, _ = make_correlated_survival(
        SyntheticSpec(n=300, p=20, k=4, rho=0.7, seed=2))
    return x.astype(np.float64), t, delta


@pytest.fixture(scope="module")
def problem():
    return cox.prepare(*_problem_arrays(), device="cpu")


@pytest.fixture(scope="module")
def newton_ls_optimum(problem):
    return float(solvers.fit_newton(problem, lam2=1.0, n_iters=40,
                                    line_search=True,
                                    device="cpu").objective[-1])


@pytest.mark.parametrize("name", ["cd_quad", "cd_cubic", "quasi_newton",
                                  "prox_newton"])
def test_all_solvers_reach_same_smooth_optimum(problem, newton_ls_optimum,
                                               name):
    """lam2 > 0 -> strongly convex, unique optimum; every convergent method
    must agree. newton_ls is the high-precision reference."""
    res = solvers.SOLVERS[name](problem, 0.0, 1.0, 400, device="cpu")
    assert float(res.objective[-1]) <= newton_ls_optimum + 1e-6, (
        name, float(res.objective[-1]), newton_ls_optimum)


def test_cd_l1_matches_prox_newton_optimum(problem):
    """Same convex l1+l2 objective -> same optimal value across methods."""
    r1 = solvers.fit_cd(problem, lam1=1.0, lam2=1.0, n_iters=500,
                        method="cd_quad", device="cpu")
    r2 = solvers.fit_cd(problem, lam1=1.0, lam2=1.0, n_iters=500,
                        method="cd_cubic", device="cpu")
    r3 = solvers.fit_working_newton(problem, lam1=1.0, lam2=1.0,
                                    n_iters=200, variant="prox",
                                    device="cpu")
    f1, f2, f3 = (float(r.objective[-1]) for r in (r1, r2, r3))
    assert abs(f1 - f2) < 1e-6
    assert f1 <= f3 + 1e-5


def _blow_up_arrays():
    """Rare, heavy-tailed features: the risk-set variance (the 2nd
    partial) is tiny at beta = 0 while the gradient is O(1), so the raw
    Newton step overshoots into the loss's linear tail (Fig. 1a)."""
    rng = np.random.default_rng(1)
    n, p = 120, 4
    x = ((rng.uniform(size=(n, p)) < 0.04)
         * rng.lognormal(1.5, 1.0, size=(n, p))).astype(np.float64)
    risk = np.clip(x @ np.array([3.0, -3.0, 2.0, -2.0]), -30, 30)
    t = (-np.log(rng.uniform(1e-12, 1, n)) / np.exp(risk)) ** 0.3
    delta = (rng.uniform(size=n) < 0.8).astype(np.float64)
    return x, t, delta


def test_exact_newton_blows_up_without_line_search():
    """From beta = 0 with weak regularization the pure Newton step
    overshoots and the loss explodes or rises, while CD stays monotone on
    the same problem; the port returns the trace, it does not raise."""
    data = cox.prepare(*_blow_up_arrays(), device="cpu")
    res = solvers.fit_newton(data, lam2=0.0, n_iters=12, line_search=False,
                             device="cpu")
    obj = res.objective.numpy()
    assert obj.shape == (12,)
    bad = (~np.all(np.isfinite(obj))) or np.any(np.diff(obj) > 1e-6) or \
        float(obj[-1]) > float(obj[0])
    assert bad, "expected divergence-style behaviour from raw Newton"
    res_cd = solvers.fit_cd(data, lam2=0.0, n_iters=12, method="cd_quad",
                            device="cpu")
    obj_cd = res_cd.objective.numpy()
    assert np.all(np.isfinite(obj_cd))
    assert np.all(np.diff(obj_cd) <= 1e-9)


def test_newton_on_a_singular_hessian_gives_nan_not_an_error(
        problem, monkeypatch):
    """A Hessian that holds NaN (a diverged iterate's) or is singular gives
    a non-finite step, as jnp.linalg.solve does, and no exception."""
    bad = torch.full((problem.p,), float("nan"), dtype=F64)
    res = solvers.fit_newton(problem, lam2=0.0, n_iters=2, beta0=bad,
                             device="cpu")
    assert not np.any(np.isfinite(res.objective.numpy()))
    # exactly singular once the 1e-9 ridge is added
    monkeypatch.setattr(cox, "exact_hessian", lambda data, eta: -1e-9 * (
        torch.eye(data.p, dtype=eta.dtype)))
    res = solvers.fit_newton(problem, lam2=0.0, n_iters=1, device="cpu")
    assert not np.isfinite(float(res.objective[0]))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_gd_decreases(problem, use_kernel):
    res = solvers.fit_gd(problem, lam1=0.5, lam2=0.5, n_iters=100,
                         use_kernel=use_kernel, device="cpu")
    obj = res.objective.numpy()
    assert np.all(np.isfinite(obj))
    assert float(obj[-1]) < float(obj[0])


def test_solvers_table_has_the_references_keys():
    assert sorted(solvers.SOLVERS) == sorted(jsolvers.SOLVERS)


def test_new_fits_raise_without_cuda_unless_asked(problem):
    fits = (lambda **kw: solvers.fit_newton(problem, n_iters=1, **kw),
            lambda **kw: solvers.fit_working_newton(problem, n_iters=1, **kw),
            lambda **kw: solvers.fit_gd(problem, n_iters=1, **kw),
            lambda **kw: solvers.fit_cd_penalized(problem, n_iters=1, **kw))
    for fit in fits:
        with pytest.raises(ValueError, match="lies on"):
            fit(device="meta")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fit()
    with pytest.raises(ValueError, match="variant"):
        solvers.fit_working_newton(problem, variant="full", device="cpu")


# ---------------------------------------------------------------------------
# KKT at the CD fixed point (tests/test_optimality_elastic.py)
# ---------------------------------------------------------------------------

@settings(max_examples=8, deadline=None)
@given(st.integers(0, 10**6), st.floats(0.5, 4.0))
def test_l1_fixed_point_satisfies_kkt(seed, lam1):
    """At the converged l1+l2 CD solution: |grad_l + 2 lam2 b_l| <= lam1
    for zero coords; == -lam1*sign(b_l) for active coords (subgradient
    stationarity)."""
    x, t, delta, _ = make_correlated_survival(
        SyntheticSpec(n=250, p=15, k=4, rho=0.6, seed=seed % 13,
                      censor_scale=3.0))
    lam2 = 0.5
    data = cox.prepare(x.astype(np.float64), t, delta, device="cpu")
    beta = solvers.fit_cd(data, lam1=lam1, lam2=lam2, n_iters=400,
                          device="cpu").beta
    g = (cox.grad_all(data, data.x @ beta) + 2.0 * lam2 * beta).numpy()
    b = beta.numpy()
    tol = 1e-3 * max(lam1, 1.0)
    for l in range(len(b)):
        if abs(b[l]) < 1e-10:
            assert abs(g[l]) <= lam1 + tol, (l, g[l], lam1)
        else:
            assert abs(g[l] + lam1 * np.sign(b[l])) <= tol, (l, g[l], b[l])


# ---------------------------------------------------------------------------
# Parity with the JAX package (float64): objective traces and beta
# ---------------------------------------------------------------------------

_PARITY = {
    "newton": ("fit_newton", dict(lam2=0.5, n_iters=6, line_search=False)),
    "newton_ls": ("fit_newton", dict(lam2=0.5, n_iters=6, line_search=True)),
    "quasi": ("fit_working_newton", dict(lam1=0.4, lam2=0.5, n_iters=5,
                                         variant="quasi", inner_sweeps=2)),
    "prox": ("fit_working_newton", dict(lam1=0.4, lam2=0.5, n_iters=5,
                                        variant="prox", inner_sweeps=2)),
    "gd": ("fit_gd", dict(lam1=0.4, lam2=0.5, n_iters=15)),
    "scad": ("fit_cd_penalized", dict(penalty="scad", lam1=0.6, lam2=0.1,
                                      n_iters=8)),
    "mcp": ("fit_cd_penalized", dict(penalty="mcp", lam1=0.6, gamma=3.0,
                                     lam2=0.1, n_iters=8)),
}
_KERNEL_FITS = ("fit_gd", "fit_cd_penalized")


def _cases():
    for name, (fn, _) in sorted(_PARITY.items()):
        for kind in ("appendix_c", "tied"):
            for use_kernel in ((True, False) if fn in _KERNEL_FITS
                               else (None,)):
                yield pytest.param(name, kind, use_kernel,
                                   id=f"{name}-{kind}-{use_kernel}")


@pytest.mark.parametrize("name,kind,use_kernel", list(_cases()))
def test_baseline_matches_jax(name, kind, use_kernel):
    fn, kw = _PARITY[name]
    if kind == "tied":
        x, t, delta = make_tied_survival(n=200, p=8, n_times=12, seed=9)
        x = x.astype(np.float64)
    else:
        x, t, delta = _problem_arrays()
    beta0 = np.random.default_rng(3).standard_normal(x.shape[1]) * 0.05
    with jax.enable_x64(True):
        want = getattr(jsolvers, fn)(jcox.prepare(x, t, delta),
                                     beta0=jnp.asarray(beta0), **kw)
        want_obj, want_beta = np.asarray(want.objective), np.asarray(
            want.beta)
    extra = {} if use_kernel is None else {"use_kernel": use_kernel}
    got = getattr(solvers, fn)(cox.prepare(x, t, delta, device="cpu"),
                               beta0=torch.as_tensor(beta0), device="cpu",
                               **kw, **extra)
    assert got.n_iters == len(want_obj)
    np.testing.assert_allclose(got.objective.numpy(), want_obj, rtol=RTOL)
    np.testing.assert_allclose(got.beta.numpy(), want_beta, rtol=RTOL,
                               atol=1e-10)
