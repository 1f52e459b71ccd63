"""Port's core/stratified.py, survival/cv.py and the evaluation metrics:
the reference's own checks (tests/test_extensions.py's stratified, Efron
and cross-validation tests) against the port, and parity with the JAX
package on the same numpy inputs in float64, within 1e-8 relative (the
packages sum in different orders); the integer outputs (the sort order,
risk_start, tie_end, the folds) and the numpy-only metrics exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import stratified as jstrat  # noqa: E402
from repro.survival import cv as jcv  # noqa: E402
from repro.survival import metrics as jmetrics  # noqa: E402
from repro_torch.core import cox, solvers, stratified  # noqa: E402
from repro_torch.data.synthetic import (SyntheticSpec,  # noqa: E402
                                        make_correlated_survival)
from repro_torch.survival import cv, metrics  # noqa: E402

RTOL = 1e-8


# ---------------------------------------------------------------------------
# Stratified CPH
# ---------------------------------------------------------------------------

def test_stratified_loss_equals_sum_of_per_stratum_losses():
    rng = np.random.default_rng(0)
    n, p = 120, 5
    x = rng.standard_normal((n, p))
    t = rng.uniform(1, 2, n)
    delta = (rng.uniform(size=n) < 0.7).astype(float)
    strata = rng.integers(0, 3, n)
    beta = torch.as_tensor(rng.standard_normal(p) * 0.4)

    total = stratified.stratified_loss(x, t, delta, strata, beta,
                                       device="cpu")
    expect = 0.0
    for s in range(3):
        m = strata == s
        data_s = cox.prepare(x[m], t[m], delta[m], device="cpu")
        expect += float(cox.loss_from_eta(data_s, data_s.x @ beta))
    np.testing.assert_allclose(float(total), expect, rtol=1e-8)


def test_stratified_single_stratum_matches_plain():
    rng = np.random.default_rng(1)
    n, p = 80, 4
    x = rng.standard_normal((n, p))
    t = np.round(rng.uniform(1, 2, n), 2)  # ties too
    delta = (rng.uniform(size=n) < 0.7).astype(float)
    beta = torch.as_tensor(rng.standard_normal(p) * 0.3)
    data = cox.prepare(x, t, delta, device="cpu")
    plain = float(cox.loss_from_eta(data, data.x @ beta))
    strat = float(stratified.stratified_loss(
        x, t, delta, np.zeros(n, np.int32), beta, device="cpu"))
    np.testing.assert_allclose(strat, plain, rtol=1e-8)


# ---------------------------------------------------------------------------
# Efron ties
# ---------------------------------------------------------------------------

def test_efron_equals_breslow_without_ties():
    rng = np.random.default_rng(2)
    n = 100
    t = rng.uniform(1, 2, n)  # continuous: no ties
    delta = (rng.uniform(size=n) < 0.6).astype(float)
    eta = torch.as_tensor(rng.standard_normal(n) * 0.5)
    data = cox.prepare(np.zeros((n, 1)), t, delta, device="cpu")
    order = torch.argsort(torch.as_tensor(t))
    breslow = float(cox.loss_from_eta(data, eta[order]))
    efron = float(stratified.efron_loss(t, delta, eta, device="cpu"))
    np.testing.assert_allclose(efron, breslow, rtol=1e-7)


def test_efron_less_than_breslow_with_ties():
    """Efron's correction shrinks the risk set within a tie group, so the
    per-event log-denominator (and the loss) is <= Breslow's."""
    rng = np.random.default_rng(3)
    n = 120
    t = np.ceil(rng.uniform(0, 1, n) * 8) / 8  # heavy ties
    delta = np.ones(n)
    eta = torch.as_tensor(rng.standard_normal(n) * 0.5)
    data = cox.prepare(np.zeros((n, 1)), t, delta, device="cpu")
    order = torch.argsort(torch.as_tensor(t), stable=True)
    breslow = float(cox.loss_from_eta(data, eta[order]))
    efron = float(stratified.efron_loss(t, delta, eta, device="cpu"))
    assert efron < breslow


# ---------------------------------------------------------------------------
# CV driver
# ---------------------------------------------------------------------------

def _cv_arrays():
    return make_correlated_survival(
        SyntheticSpec(n=300, p=30, k=4, rho=0.5, seed=5, censor_scale=3.0))


@pytest.mark.parametrize("returns", ["tensor", "array"])
def test_cross_validation_protocol(returns):
    x, t, delta, _ = _cv_arrays()

    def fit(data):
        beta = solvers.fit_cd(data, lam2=1.0, n_iters=40, device="cpu").beta
        return beta if returns == "tensor" else beta.numpy()

    out = cv.cross_validate(x, t, delta, fit, k=5, device="cpu")
    assert 0.6 < out["cindex_mean"] <= 1.0
    assert out["ibs_mean"] < 0.25
    assert out["cindex_std"] < 0.2


def test_cross_validate_raises_without_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    x, t, delta, _ = _cv_arrays()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cv.cross_validate(x, t, delta, lambda d: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stratified.prepare_stratified(x, t, delta, np.zeros(len(t)))


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------

def _strat_arrays(ties: bool):
    rng = np.random.default_rng(7)
    n, p = 150, 6
    x = rng.standard_normal((n, p))
    t = rng.uniform(1, 2, n)
    if ties:
        t = np.round(t, 1)
    delta = (rng.uniform(size=n) < 0.7).astype(float)
    strata = rng.integers(0, 4, n)
    beta = rng.standard_normal(p) * 0.4
    return x, t, delta, strata, beta


@pytest.mark.parametrize("ties", [False, True])
def test_prepare_stratified_matches_jax(ties):
    x, t, delta, strata, _ = _strat_arrays(ties)
    with jax.enable_x64(True):
        jdata, jorder, jss = jstrat.prepare_stratified(x, t, delta, strata)
        want = {"x": np.asarray(jdata.x), "delta": np.asarray(jdata.delta),
                "risk_start": np.asarray(jdata.risk_start),
                "tie_end": np.asarray(jdata.tie_end),
                "order": np.asarray(jorder), "strata": np.asarray(jss)}
    data, order, ss = stratified.prepare_stratified(x, t, delta, strata,
                                                    device="cpu")
    got = {"x": data.x, "delta": data.delta, "risk_start": data.risk_start,
           "tie_end": data.tie_end, "order": order, "strata": ss}
    for key, value in got.items():
        np.testing.assert_array_equal(value.numpy(), want[key], err_msg=key)
    assert data.risk_start.dtype == data.tie_end.dtype == torch.int32
    np.testing.assert_array_equal(data.xT.numpy(), want["x"].T)
    assert data.xT.is_contiguous()


@pytest.mark.parametrize("ties", [False, True])
def test_stratified_and_efron_losses_match_jax(ties):
    x, t, delta, strata, beta = _strat_arrays(ties)
    eta = x @ beta
    with jax.enable_x64(True):
        want_s = float(jstrat.stratified_loss(x, t, delta, strata,
                                              jnp.asarray(beta)))
        want_e = float(jstrat.efron_loss(jnp.asarray(t), jnp.asarray(delta),
                                         jnp.asarray(eta)))
    got_s = stratified.stratified_loss(x, t, delta, strata, beta,
                                       device="cpu")
    got_e = stratified.efron_loss(t, delta, eta, device="cpu")
    np.testing.assert_allclose(float(got_s), want_s, rtol=RTOL)
    np.testing.assert_allclose(float(got_e), want_e, rtol=RTOL)


@pytest.mark.parametrize("ties", [False, True])
def test_cindex_and_ibs_match_jax(ties):
    x, t, delta, _, beta = _strat_arrays(ties)
    eta = x @ beta
    half = len(t) // 2
    assert metrics.cindex(t, delta, eta) == jmetrics.cindex(t, delta, eta)
    assert metrics.cindex(t, delta, eta, chunk=7) == \
        jmetrics.cindex(t, delta, eta, chunk=7)
    args = (t[:half], delta[:half], eta[:half], t[half:], delta[half:],
            eta[half:])
    assert metrics.ibs(*args) == jmetrics.ibs(*args)
    h0, jh0 = (m.breslow_baseline(t, delta, eta) for m in (metrics,
                                                          jmetrics))
    np.testing.assert_array_equal(h0(t), jh0(t))


@pytest.mark.parametrize("n,k,seed", [(300, 5, 0), (509, 4, 3), (7, 3, 1)])
def test_kfold_indices_match_jax(n, k, seed):
    got = cv.kfold_indices(n, k, seed)
    want = jcv.kfold_indices(n, k, seed)
    assert len(got) == len(want) == k
    for (tr, te), (jtr, jte) in zip(got, want):
        np.testing.assert_array_equal(tr, jtr)
        np.testing.assert_array_equal(te, jte)
