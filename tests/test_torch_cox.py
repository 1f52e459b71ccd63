"""Port's core/cox.py: the reference's Theorem 3.1 / Lemma 3.2 / Corollary
3.3 checks against autodiff (torch.autograd in place of jax.grad), and
parity with the JAX package on the same numpy inputs, in float64.

Tolerance: 1e-8 relative in float64 (the two packages sum in different
orders; everything else is the same arithmetic)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cox as jcox  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import cox  # noqa: E402
from repro_torch.data.synthetic import (SyntheticSpec,  # noqa: E402
                                        make_correlated_survival,
                                        make_tied_survival)

RTOL = 1e-8


def naive_loss(x, t, delta, beta):
    """O(n^2) direct implementation of Eq. (4) with Breslow risk sets."""
    eta = x @ beta
    total = 0.0
    for i in range(x.shape[0]):
        mask = (t >= t[i]).to(eta.dtype)
        total = total + delta[i] * (
            torch.log(torch.sum(mask * torch.exp(eta))) - eta[i])
    return total


@pytest.fixture(scope="module")
def small():
    x, t, delta = make_tied_survival(n=60, p=5, n_times=12, seed=1)
    x = x.astype(np.float64)
    data = cox.prepare(x, t, delta, device="cpu")
    rng = np.random.default_rng(3)
    beta = torch.as_tensor(rng.standard_normal(5) * 0.3)
    xt = torch.as_tensor(x)
    tt = torch.as_tensor(t.astype(np.float64))
    dt = torch.as_tensor(delta.astype(np.float64))
    return xt, tt, dt, data, beta


# ---------------------------------------------------------------------------
# The reference's own checks (tests/test_cox_math.py), on the port
# ---------------------------------------------------------------------------

def test_loss_matches_naive(small):
    x, t, delta, data, beta = small
    np.testing.assert_allclose(cox.objective(data, beta),
                               naive_loss(x, t, delta, beta), rtol=1e-10)


def test_grad_all_matches_autodiff(small):
    x, t, delta, data, beta = small
    b = beta.clone().requires_grad_(True)
    (g_ref,) = torch.autograd.grad(naive_loss(x, t, delta, b), b)
    g = cox.grad_all(data, data.x @ beta)
    np.testing.assert_allclose(g, g_ref, rtol=1e-8, atol=1e-10)


def test_coord_derivs_match_autodiff(small):
    x, t, delta, data, beta = small
    f = lambda b: naive_loss(x, t, delta, b)  # noqa: E731
    b = beta.clone().requires_grad_(True)
    (g_ref,) = torch.autograd.grad(f(b), b)
    h_ref = torch.diagonal(torch.autograd.functional.hessian(f, beta))
    for l in range(data.p):
        s = beta[l].clone().requires_grad_(True)
        fl = f(torch.cat([beta[:l], s.reshape(1), beta[l + 1:]]))
        (d1,) = torch.autograd.grad(fl, s, create_graph=True)
        (d2,) = torch.autograd.grad(d1, s, create_graph=True)
        (d3,) = torch.autograd.grad(d2, s)
        g, h, c3 = cox.coord_derivs(data, data.x @ beta, data.x[:, l],
                                    order=3)
        np.testing.assert_allclose(g, g_ref[l], rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(h, h_ref[l], rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(c3, d3, rtol=1e-6, atol=1e-8)


def test_grad_hess_all_matches_coord(small):
    _, _, _, data, beta = small
    eta = data.x @ beta
    g_all, h_all = cox.grad_hess_all(data, eta)
    for l in range(data.p):
        g, h, _ = cox.coord_derivs(data, eta, data.x[:, l])
        np.testing.assert_allclose(g_all[l], g, rtol=1e-9)
        np.testing.assert_allclose(h_all[l], h, rtol=1e-9)


def test_exact_hessian_matches_autodiff(small):
    x, t, delta, data, beta = small
    h_ref = torch.autograd.functional.hessian(
        lambda b: naive_loss(x, t, delta, b), beta)
    np.testing.assert_allclose(cox.exact_hessian(data, data.x @ beta), h_ref,
                               rtol=1e-7, atol=1e-9)


def test_eta_gradient_matches_autodiff(small):
    _, _, _, data, beta = small
    eta = (data.x @ beta).requires_grad_(True)
    (g_ref,) = torch.autograd.grad(cox.loss_from_eta(data, eta), eta)
    np.testing.assert_allclose(cox.eta_gradient(data, eta.detach()), g_ref,
                               rtol=1e-8, atol=1e-10)


def test_eta_hessian_diag_matches_autodiff(small):
    _, _, _, data, beta = small
    eta = data.x @ beta
    h_full = torch.autograd.functional.hessian(
        lambda e: cox.loss_from_eta(data, e), eta)
    np.testing.assert_allclose(cox.eta_hessian_diag(data, eta),
                               torch.diagonal(h_full), rtol=1e-7, atol=1e-10)
    # majorant dominates the diagonal
    assert torch.all(cox.eta_hessian_upper(data, eta)
                     >= torch.diagonal(h_full) - 1e-12)


def test_moment_recursion_lemma_3_2(small):
    """dC_r/dbeta_l == C_{r+1} - r C_2 C_{r-1}, checked per event row."""
    _, _, _, data, beta = small
    l = 2
    xl = data.x[:, l]

    def cr_of_beta(b, r):
        return cox.central_moment(data, data.x @ b, xl, r)

    for r in (2, 3, 4):
        jac = torch.autograd.functional.jacobian(
            lambda b: cr_of_beta(b, r), beta)[:, l]
        rhs = (cr_of_beta(beta, r + 1)
               - r * cr_of_beta(beta, 2) * cr_of_beta(beta, r - 1))
        np.testing.assert_allclose(jac, rhs, rtol=1e-6, atol=1e-9)


def test_third_derivative_not_fourth_moment(small):
    """For r >= 3 the pattern breaks: C_2' == C_3 but C_3' != C_4."""
    _, _, _, data, beta = small
    l = 1
    xl = data.x[:, l]
    jac3 = torch.autograd.functional.jacobian(
        lambda b: cox.central_moment(data, data.x @ b, xl, 3), beta)[:, l]
    c4 = cox.central_moment(data, data.x @ beta, xl, 4)
    assert not np.allclose(jac3.numpy(), c4.numpy(), rtol=1e-3)


# ---------------------------------------------------------------------------
# Parity with the JAX package, float64, same numpy inputs
# ---------------------------------------------------------------------------

def _dataset(kind):
    if kind == "tie_free":
        rng = np.random.default_rng(11)
        n, p = 300, 7
        x = rng.standard_normal((n, p))
        t = rng.permutation(1.0 + np.arange(n) / n).astype(np.float32)
        delta = (rng.uniform(size=n) < 0.6).astype(np.float32)
    elif kind == "tied":
        x, t, delta = make_tied_survival(n=250, p=6, n_times=15, seed=4)
    else:
        x, t, delta, _ = make_correlated_survival(
            SyntheticSpec(n=400, p=12, k=3, rho=0.9, seed=0))
    x = np.asarray(x, np.float64)
    beta = np.random.default_rng(5).standard_normal(x.shape[1]) * 0.3
    return x, t, delta, beta


# name -> (port fn, JAX fn); each takes (cox module, data, eta, beta)
_FUNCS = {
    "objective": lambda m, d, e, b: m.objective(d, b, 0.3, 0.2),
    "risk_stats": lambda m, d, e, b: m.risk_stats(d, e),
    "eta_gradient": lambda m, d, e, b: m.eta_gradient(d, e),
    "grad_all": lambda m, d, e, b: m.grad_all(d, e),
    "grad_hess_all": lambda m, d, e, b: m.grad_hess_all(d, e),
    "exact_hessian": lambda m, d, e, b: m.exact_hessian(d, e),
    "eta_hessian_diag": lambda m, d, e, b: m.eta_hessian_diag(d, e),
    "eta_hessian_upper": lambda m, d, e, b: m.eta_hessian_upper(d, e),
    "coord_derivs": lambda m, d, e, b: m.coord_derivs(d, e, d.x[:, 2],
                                                      order=3),
    "lipschitz_constants": lambda m, d, e, b: m.lipschitz_constants(d),
    "central_moment": lambda m, d, e, b: m.central_moment(d, e, d.x[:, 1],
                                                          4),
}


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [np.asarray(o, np.float64) for o in out]
    return [np.asarray(out, np.float64)]


@pytest.mark.parametrize("kind", ["tie_free", "tied", "appendix_c"])
@pytest.mark.parametrize("name", sorted(_FUNCS))
def test_matches_jax(kind, name):
    x, t, delta, beta = _dataset(kind)
    fn = _FUNCS[name]
    with jax.enable_x64(True):
        jd = jcox.prepare(x, t, delta)
        jb = jnp.asarray(beta)
        want = _flat(fn(jcox, jd, jd.x @ jb, jb))
    td = cox.prepare(x, t, delta, device="cpu")
    tb = torch.as_tensor(beta)
    got = _flat(fn(cox, td, td.x @ tb, tb))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        scale = np.max(np.abs(w)) if w.size else 1.0
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("kind", ["tie_free", "tied", "appendix_c"])
def test_prepare_matches_jax(kind):
    x, t, delta, _ = _dataset(kind)
    with jax.enable_x64(True):
        jd = jcox.prepare(x, t, delta)
        want = {f: np.asarray(getattr(jd, f))
                for f in ("x", "delta", "risk_start", "tie_end")}
    td = cox.prepare(x, t, delta, device="cpu")
    for f, w in want.items():
        np.testing.assert_array_equal(getattr(td, f).numpy(), w, err_msg=f)
    np.testing.assert_array_equal(td.xT.numpy(), want["x"].T)
    assert td.xT.is_contiguous() and td.risk_start.dtype == torch.int32


def test_generators_match_reference():
    spec = SyntheticSpec(n=150, p=9, k=3, rho=0.8, seed=7)
    jspec = jsyn.SyntheticSpec(n=150, p=9, k=3, rho=0.8, seed=7)
    for a, b in zip(make_correlated_survival(spec),
                    jsyn.make_correlated_survival(jspec)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(make_tied_survival(n=90, seed=3),
                    jsyn.make_tied_survival(n=90, seed=3)):
        np.testing.assert_array_equal(a, b)


def test_prepare_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    x, t, delta = make_tied_survival(n=20, p=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cox.prepare(x, t, delta)
