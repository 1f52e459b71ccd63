"""The port's main path end to end against the JAX package: Appendix-C data
-> prepare -> fit_cd -> Breslow/Efron artifact -> batched scoring, on the
same numpy inputs.

Tolerances: float64 fits to 1e-8 relative (same arithmetic, summed in
other orders); the float32 fit against the JAX Pallas path to the
tests/test_kernels.py fit tolerances (1e-4 objective, 1e-3 beta); the
float32 artifact and scores to 2e-6 and 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import cox as jcox  # noqa: E402
from repro.core import solvers as jsolvers  # noqa: E402
from repro.serving import ScoringEngine as JEngine  # noqa: E402
from repro.serving import fit_survival_model as j_fit  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import solvers  # noqa: E402
from repro_torch.data.synthetic import (SyntheticSpec,  # noqa: E402
                                        make_correlated_survival)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import ScoringEngine, fit_survival_model  # noqa: E402

SPEC = SyntheticSpec(n=600, p=24, k=4, rho=0.9, seed=0)
LAM1, LAM2, SWEEPS = 30.0, 1.0, 10   # lam1 ~ 0.3 max|grad loss(0)|


@pytest.fixture(scope="module")
def appendix_c():
    x, t, delta, _ = make_correlated_survival(SPEC)
    assert len(np.unique(t)) == SPEC.n   # tie-free at this size
    return x, t, delta


def _jax_fit(x, t, delta, method, use_kernel):
    x64 = not use_kernel
    with jax.enable_x64(x64):
        xx = x.astype(np.float64) if x64 else x
        res = jsolvers.fit_cd(jcox.prepare(xx, t, delta), lam1=LAM1,
                              lam2=LAM2, n_iters=SWEEPS, method=method,
                              use_kernel=use_kernel)
        return np.asarray(res.objective), np.asarray(res.beta)


@pytest.mark.parametrize("method", ["cd_quad", "cd_cubic"])
def test_slice_float64_matches_jax(appendix_c, method):
    x, t, delta = appendix_c
    want_obj, want_beta = _jax_fit(x, t, delta, method, use_kernel=False)
    data = convert.cox_data_from_numpy(x.astype(np.float64), t, delta,
                                       device="cpu")
    res = solvers.fit_cd(data, lam1=LAM1, lam2=LAM2, n_iters=SWEEPS,
                         method=method, device="cpu")
    np.testing.assert_allclose(res.objective.numpy(), want_obj, rtol=1e-8)
    np.testing.assert_allclose(res.beta.numpy(), want_beta, rtol=1e-8,
                               atol=1e-10)
    assert np.all(np.diff(res.objective.numpy()) <= 1e-9)
    assert 0 < np.count_nonzero(res.beta.numpy()) < SPEC.p   # lam1 bites

    beta = res.beta.numpy().astype(np.float32)
    for ties in ("breslow", "efron"):
        got = fit_survival_model(x, t, delta, beta, ties=ties, device="cpu")
        want = j_fit(x, t, delta, beta, ties=ties)
        np.testing.assert_allclose(got.base_cumhaz, want.base_cumhaz,
                                   rtol=2e-6, atol=1e-7)

    model = fit_survival_model(x, t, delta, beta, device="cpu")
    jmodel = j_fit(x, t, delta, beta)
    q = x[:37]
    for use_sparse in (False, True):
        eng = ScoringEngine(model, use_sparse=use_sparse, device="cpu")
        jeng = JEngine(jmodel, use_sparse=use_sparse)
        got, want = eng.score(q, with_curves=True), jeng.score(
            q, with_curves=True)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", ["cd_quad", "cd_cubic"])
def test_slice_float32_kernel_path_matches_jax_pallas(method):
    """The setup of tests/test_kernels.py::test_fit_cd_with_pallas_kernel_path:
    the port's kernel path (its plain versions here) walks the trajectory of
    JAX fit_cd(use_kernel=True) in interpret mode on tie-free float32."""
    rng = np.random.default_rng(7)
    n, p = 300, 10
    x = rng.standard_normal((n, p)).astype(np.float32)
    t = rng.uniform(1.0, 2.0, size=n).astype(np.float32)
    assert len(np.unique(t)) == n
    delta = (rng.uniform(size=n) < 0.6).astype(np.float32)
    with jax.enable_x64(False):
        res_j = jsolvers.fit_cd(jcox.prepare(x, t, delta), lam1=0.5,
                                lam2=0.5, n_iters=8, method=method,
                                use_kernel=True)
        want_obj, want_beta = np.asarray(res_j.objective), np.asarray(
            res_j.beta)
    before = ops._M_DISPATCH.value(kernel="cox_coord", route="plain")
    res = solvers.fit_cd(convert.cox_data_from_numpy(x, t, delta, "cpu"),
                         lam1=0.5, lam2=0.5, n_iters=8, method=method,
                         device="cpu")
    assert res.beta.dtype == torch.float32
    assert ops._M_DISPATCH.value(kernel="cox_coord",
                                 route="plain") == before + 8 * p
    np.testing.assert_allclose(res.objective.numpy(), want_obj, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(res.beta.numpy(), want_beta, rtol=1e-3,
                               atol=1e-4)


def test_convert_carries_reference_state():
    x, t, delta, _ = make_correlated_survival(
        SyntheticSpec(n=120, p=6, k=2, seed=3))
    beta = np.linspace(-0.5, 0.5, 6).astype(np.float32)
    beta[2] = 0.0
    jm = j_fit(x, t, delta, beta)
    arrays = {f: getattr(jm, f) for f in ("beta", "time_grid", "base_cumhaz",
                                          "support", "beta_support",
                                          "strata_labels")}
    tm = convert.model_from_reference(arrays, jm.ties)
    for f, a in arrays.items():
        if a is None:
            assert getattr(tm, f) is None
        else:
            np.testing.assert_array_equal(getattr(tm, f), a)
    with pytest.raises(ValueError, match="unknown"):
        convert.model_from_reference({**arrays, "bogus": beta}, "breslow")
    b = convert.beta_to_device(beta, "cpu")
    assert b.dtype == torch.float32 and np.array_equal(b.numpy(), beta)
    data = convert.cox_data_from_numpy(x.astype(np.float64), t, delta, "cpu")
    assert data.x.dtype == torch.float64 and data.delta.dtype == torch.float64
