"""Port's core/surrogate.py and core/solvers.py: the reference's own checks
(tests/test_surrogates.py grid searches, tests/test_solvers.py monotone
descent and fit_cd_tol), and parity with the JAX package on the same numpy
inputs in float64 (1e-8 relative; the packages sum in different orders)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import example, given, settings, strategies as st  # noqa: E402

from repro.core import cox as jcox  # noqa: E402
from repro.core import solvers as jsolvers  # noqa: E402
from repro.core import surrogate as jsur  # noqa: E402
from repro_torch.core import cox, solvers, surrogate  # noqa: E402
from repro_torch.data.synthetic import (SyntheticSpec,  # noqa: E402
                                        make_correlated_survival,
                                        make_tied_survival)

finite = st.floats(min_value=-50, max_value=50, allow_nan=False)
pos = st.floats(min_value=1e-3, max_value=50, allow_nan=False)
nonneg = st.floats(min_value=0.0, max_value=50, allow_nan=False)
F64 = torch.float64


def _s(v):
    return torch.tensor(v, dtype=F64)


# ---------------------------------------------------------------------------
# Theorem 3.4: L2/L3 bound the 2nd/3rd partials at *any* beta
# ---------------------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=0, max_value=10**6), st.floats(-2.0, 2.0))
def test_lipschitz_bounds_hold_everywhere(seed, scale):
    x, t, delta = make_tied_survival(n=50, p=4, n_times=8, seed=seed % 17)
    data = cox.prepare(x.astype(np.float64), t, delta, device="cpu")
    l2c, l3c = cox.lipschitz_constants(data)
    rng = np.random.default_rng(seed)
    eta = data.x @ torch.as_tensor(rng.standard_normal(4) * scale)
    for l in range(4):
        _, h, c3 = cox.coord_derivs(data, eta, data.x[:, l], order=3)
        assert -1e-9 <= float(h) <= float(l2c[l]) + 1e-9
        assert abs(float(c3)) <= float(l3c[l]) + 1e-9


def test_surrogates_majorize_along_coordinates():
    """f(x + D e_l) <= quadratic / cubic surrogate value, random D sweep."""
    x, t, delta = make_tied_survival(n=80, p=5, n_times=10, seed=3)
    data = cox.prepare(x.astype(np.float64), t, delta, device="cpu")
    l2c, l3c = cox.lipschitz_constants(data)
    rng = np.random.default_rng(0)
    beta = torch.as_tensor(rng.standard_normal(5) * 0.4)
    f0 = cox.objective(data, beta)
    eta = data.x @ beta
    for l in range(5):
        g, h, _ = cox.coord_derivs(data, eta, data.x[:, l])
        for d in rng.standard_normal(12) * 2.0:
            b1 = beta.clone()
            b1[l] += d
            f1 = cox.objective(data, b1)
            quad = f0 + g * d + 0.5 * l2c[l] * d * d
            cubic = f0 + g * d + 0.5 * h * d * d + l3c[l] / 6 * abs(d) ** 3
            assert float(f1) <= float(quad) + 1e-8
            assert float(f1) <= float(cubic) + 1e-8


# ---------------------------------------------------------------------------
# Analytic minimizers vs dense grid search
# ---------------------------------------------------------------------------

def _grid_argmin(fn, lo=-300.0, hi=300.0, n=600001):
    grid = torch.linspace(lo, hi, n, dtype=F64)
    return grid[torch.argmin(fn(grid))]


@settings(max_examples=40, deadline=None)
@given(finite, pos)
def test_quad_min(a, b):
    assert np.isclose(float(surrogate.quad_min(_s(a), _s(b))), -a / b,
                      rtol=1e-10)


@settings(max_examples=40, deadline=None)
@given(finite, nonneg, pos)
def test_cubic_min_vs_grid(a, b, c):
    fn = lambda d: a * d + 0.5 * b * d**2 + c / 6 * torch.abs(d) ** 3  # noqa
    step = surrogate.cubic_min(_s(a), _s(b), _s(c))
    ref = _grid_argmin(fn)
    assert float(fn(step)) <= float(fn(ref)) + 1e-5


@settings(max_examples=60, deadline=None)
@given(finite, pos, finite, nonneg)
def test_quad_l1_prox_vs_grid(a, b, c, lam1):
    fn = lambda d: a * d + 0.5 * b * d**2 + lam1 * torch.abs(c + d)  # noqa
    step = surrogate.quad_l1_prox(_s(a), _s(b), _s(c), _s(lam1))
    assert float(fn(step)) <= float(fn(_grid_argmin(fn))) + 1e-5


@settings(max_examples=60, deadline=None)
@given(finite, nonneg, pos, finite, nonneg)
def test_cubic_l1_prox_vs_grid(a, b, c, d, lam1):
    fn = lambda dd: (a * dd + 0.5 * b * dd**2 + c / 6 * torch.abs(dd) ** 3  # noqa
                     + lam1 * torch.abs(d + dd))
    step = surrogate.cubic_l1_prox(_s(a), _s(b), _s(c), _s(d), _s(lam1))
    assert float(fn(step)) <= float(fn(_grid_argmin(fn))) + 1e-5


@settings(max_examples=60, deadline=None)
@given(finite, nonneg, pos, finite, nonneg)
@example(5e-324, 0.0, 0.25, 0.0, 0.0)   # subnormal a: d == 0 branch's den is 0
def test_cubic_l1_prox_paper_formula_agrees(a, b, c, d, lam1):
    """Eq. (22) literal formula reaches the same objective value as the
    candidate-enumeration solver."""
    fn = lambda dd: (a * dd + 0.5 * b * dd**2 + c / 6 * torch.abs(dd) ** 3  # noqa
                     + lam1 * torch.abs(d + dd))
    args = [_s(v) for v in (a, b, c, d, lam1)]
    s_rob = surrogate.cubic_l1_prox(*args)
    s_pap = surrogate.cubic_l1_prox_paper(*args)
    assert np.isclose(float(fn(s_pap)), float(fn(s_rob)), rtol=1e-6,
                      atol=1e-6)


# ---------------------------------------------------------------------------
# Surrogate parity with the JAX package (float64, bitwise-equal arithmetic)
# ---------------------------------------------------------------------------

_SURROGATES = {
    "quad_min": 2, "cubic_min": 3, "quad_l1_prox": 4,
    "cubic_l1_prox": 5, "cubic_l1_prox_paper": 5, "quad_decrease": 2,
}


@pytest.mark.parametrize("name", sorted(_SURROGATES))
def test_surrogate_matches_jax(name):
    rng = np.random.default_rng(len(name))
    cols = rng.standard_normal((400, _SURROGATES[name])) * 3.0
    cols[:, 1:3] = np.abs(cols[:, 1:3])        # curvatures are >= 0
    cols[::7, -1] = 0.0                        # exact zeros hit the kinks
    if cols.shape[1] == 5:
        cols[:, 4] = np.abs(cols[:, 4])        # lam1 >= 0
    jfn, tfn = getattr(jsur, name), getattr(surrogate, name)
    with jax.enable_x64(True):
        want = [float(jfn(*map(jnp.float64, row))) for row in cols]
    got = [float(tfn(*map(_s, row))) for row in cols]
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)


def test_surrogate_takes_python_floats_at_tensor_precision():
    a = torch.tensor(0.3, dtype=F64)
    out = surrogate.quad_l1_prox(a, 2.0, torch.tensor(0.1, dtype=F64), 0.1)
    assert out.dtype == F64
    assert float(out) == pytest.approx((2.0 * 0.1 - 0.3 + 0.1) / 2.0 - 0.1,
                                       rel=1e-14)


# ---------------------------------------------------------------------------
# Solvers: the reference's checks, then parity with JAX fit_cd
# ---------------------------------------------------------------------------

def _problem_arrays():
    x, t, delta, _ = make_correlated_survival(
        SyntheticSpec(n=300, p=20, k=4, rho=0.7, seed=2))
    return x.astype(np.float64), t, delta


@pytest.fixture(scope="module")
def problem():
    return cox.prepare(*_problem_arrays(), device="cpu")


@pytest.mark.parametrize("lam1,lam2", [(0.0, 0.1), (1.0, 1.0)])
@pytest.mark.parametrize("method", ["cd_quad", "cd_cubic"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_cd_monotone_decrease(problem, lam1, lam2, method, use_kernel):
    res = solvers.fit_cd(problem, lam1=lam1, lam2=lam2, n_iters=30,
                         method=method, use_kernel=use_kernel, device="cpu")
    obj = res.objective.numpy()
    assert obj.shape == (30,) and res.n_iters == 30
    assert np.all(np.diff(obj) <= 1e-9), method
    assert np.all(np.isfinite(obj)), method


def test_cubic_converges_faster_per_iteration(problem):
    rq = solvers.fit_cd(problem, lam2=0.1, n_iters=25, method="cd_quad",
                        device="cpu")
    rc = solvers.fit_cd(problem, lam2=0.1, n_iters=25, method="cd_cubic",
                        device="cpu")
    assert float(rc.objective[-1]) <= float(rq.objective[-1]) + 1e-8


def test_fit_cd_tol_early_stops(problem):
    res = solvers.fit_cd_tol(problem, lam2=1.0, max_iters=500, tol=1e-9,
                             device="cpu")
    assert res.n_iters < 500
    with jax.enable_x64(True):
        ref = jsolvers.fit_newton(jcox.prepare(*_problem_arrays()), lam2=1.0,
                                  n_iters=40, line_search=True)
        f_ref = float(ref.objective[-1])
    assert float(res.objective[-1]) <= f_ref + 1e-5


@pytest.mark.parametrize("method", ["cd_quad", "cd_cubic"])
def test_fit_cd_tol_matches_jax(method):
    arrays = _problem_arrays()
    with jax.enable_x64(True):
        want = jsolvers.fit_cd_tol(jcox.prepare(*arrays), lam1=0.5, lam2=0.5,
                                   max_iters=60, tol=1e-6, method=method)
        want = (np.asarray(want.beta), float(want.objective[-1]),
                int(want.n_iters))
    got = solvers.fit_cd_tol(cox.prepare(*arrays, device="cpu"), lam1=0.5,
                             lam2=0.5, max_iters=60, tol=1e-6, method=method,
                             device="cpu")
    assert got.n_iters == want[2]
    np.testing.assert_allclose(float(got.objective[-1]), want[1], rtol=1e-8)
    np.testing.assert_allclose(got.beta.numpy(), want[0], rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("method", ["cd_quad", "cd_cubic"])
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("kind", ["appendix_c", "tied"])
def test_fit_cd_matches_jax_float64(method, use_kernel, kind):
    """Same objective trace and beta as JAX fit_cd(use_kernel=False), the
    reference's exact Breslow path, on untied and tied data."""
    if kind == "tied":
        x, t, delta = make_tied_survival(n=250, p=8, n_times=15, seed=6)
        x = x.astype(np.float64)
    else:
        x, t, delta = _problem_arrays()
    with jax.enable_x64(True):
        want = jsolvers.fit_cd(jcox.prepare(x, t, delta), lam1=0.8, lam2=0.5,
                               n_iters=12, method=method, use_kernel=False)
        want_obj, want_beta = np.asarray(want.objective), np.asarray(want.beta)
    got = solvers.fit_cd(cox.prepare(x, t, delta, device="cpu"), lam1=0.8,
                         lam2=0.5, n_iters=12, method=method,
                         use_kernel=use_kernel, device="cpu")
    np.testing.assert_allclose(got.objective.numpy(), want_obj, rtol=1e-8)
    np.testing.assert_allclose(got.beta.numpy(), want_beta, rtol=1e-8,
                               atol=1e-10)


def test_fit_cd_rejects_bad_calls(problem):
    with pytest.raises(ValueError, match="method"):
        solvers.fit_cd(problem, method="newton", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            solvers.fit_cd(problem, n_iters=1)
    with pytest.raises(ValueError, match="lies on"):
        solvers.fit_cd(problem, n_iters=1, device="meta")
