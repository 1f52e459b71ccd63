"""Port's core/beam.py, core/path.py and survival/metrics.py: the
reference's own checks (tests/test_selection_metrics.py) against the port,
and parity with the JAX package on the same numpy inputs in float64 on
Appendix-C and tied data: score_candidates, finetune, beam_search and
omp_greedy (the same supports at every size), lambda_max, l1_path and
adaptive_lasso, each within 1e-8 relative (the packages sum in different
orders); BeamResult.betas are float32 in both, held at float32's 1e-6."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import beam as jbeam  # noqa: E402
from repro.core import cox as jcox  # noqa: E402
from repro.core import path as jpath  # noqa: E402
from repro_torch.core import beam, cox, path, solvers  # noqa: E402
from repro_torch.data.synthetic import (SyntheticSpec,  # noqa: E402
                                        make_correlated_survival,
                                        make_tied_survival)
from repro_torch.survival import metrics  # noqa: E402

RTOL = 1e-8
BETA32_RTOL = 1e-6
USE_KERNEL = pytest.mark.parametrize("use_kernel", [True, False])


@pytest.fixture(scope="module")
def corr_problem():
    spec = SyntheticSpec(n=400, p=60, k=4, rho=0.9, seed=1)
    x, t, delta, beta_star = make_correlated_survival(spec)
    return cox.prepare(x, t, delta, device="cpu"), beta_star, (x, t, delta)


# ---------------------------------------------------------------------------
# The reference's checks (tests/test_selection_metrics.py) on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[True, False],
                ids=["use_kernel", "plain"])
def corr_beam(request, corr_problem):
    """beam_search as the reference's checks call it, once per route."""
    data, beta_star, _ = corr_problem
    k_true = int((beta_star != 0).sum())
    return request.param, beam.beam_search(
        data, k=k_true, beam_width=4, n_expand=6, use_kernel=request.param,
        device="cpu")


def test_beam_search_recovers_support_high_corr(corr_problem, corr_beam):
    data, beta_star, _ = corr_problem
    k_true = int((beta_star != 0).sum())
    _, res = corr_beam
    _, _, f1 = metrics.support_f1(beta_star, res.betas[-1])
    assert f1 >= 0.75, f1
    assert all(np.diff(res.losses) <= 1e-6)
    assert [len(s) for s in res.supports] == list(range(1, k_true + 1))
    assert all(b.dtype == np.float32 and b.shape == (data.p,)
               for b in res.betas)


def test_beam_beats_or_matches_omp(corr_problem, corr_beam):
    data, beta_star, _ = corr_problem
    use_kernel, res_b = corr_beam
    res_o = beam.omp_greedy(data, k=int((beta_star != 0).sum()),
                            use_kernel=use_kernel, device="cpu")
    assert res_b.losses[-1] <= res_o.losses[-1] + 1e-4


@USE_KERNEL
def test_l1_path_monotone_support(corr_problem, use_kernel):
    data, _, _ = corr_problem
    pr = path.l1_path(data, n_lambdas=8, lambda_min_ratio=0.05, n_iters=40,
                      use_kernel=use_kernel, device="cpu")
    assert pr.support_sizes[0] <= 1
    assert pr.support_sizes[-1] >= pr.support_sizes[0]
    assert np.all(np.isfinite(pr.losses))
    # stronger penalty -> higher (worse) unpenalized loss
    assert pr.losses[0] >= pr.losses[-1] - 1e-6


@USE_KERNEL
def test_lambda_max_kills_all_coefficients(corr_problem, use_kernel):
    data, _, _ = corr_problem
    lmax = path.lambda_max(data)
    res = solvers.fit_cd(data, lam1=lmax * 1.01, lam2=0.0, n_iters=20,
                         use_kernel=use_kernel, device="cpu")
    assert np.all(np.abs(res.beta.numpy()) < 1e-10)


def test_cindex_perfect_and_random():
    rng = np.random.default_rng(0)
    n = 200
    t = rng.uniform(0, 1, n)
    delta = np.ones(n)
    assert metrics.cindex(t, delta, -t) == 1.0
    assert metrics.cindex(t, delta, t) == 0.0
    r = metrics.cindex(t, delta, rng.standard_normal(n))
    assert 0.4 < r < 0.6


def test_cindex_against_naive():
    rng = np.random.default_rng(1)
    n = 80
    t = np.round(rng.uniform(0, 1, n), 2)  # some ties
    delta = (rng.uniform(size=n) < 0.6).astype(float)
    risk = rng.standard_normal(n)
    num, den = 0.0, 0
    for i in range(n):
        for j in range(n):
            if delta[i] == 1 and t[i] < t[j]:
                den += 1
                if risk[i] > risk[j]:
                    num += 1
                elif np.isclose(risk[i], risk[j]):
                    num += 0.5
    assert np.isclose(metrics.cindex(t, delta, risk), num / den)


def test_ibs_discriminative_model_beats_null(corr_problem):
    _, beta_star, (x, t, delta) = corr_problem
    eta_good = x @ beta_star
    eta_null = np.zeros(len(t))
    ibs_good = metrics.ibs(t, delta, eta_good, t, delta, eta_good)
    ibs_null = metrics.ibs(t, delta, eta_null, t, delta, eta_null)
    assert ibs_good < ibs_null
    assert 0.0 <= ibs_good <= 0.5


def test_support_f1():
    bs = np.zeros(10)
    bs[[1, 3, 5]] = 1.0
    bh = np.zeros(10)
    bh[[1, 3]] = 0.7
    p, r, f1 = metrics.support_f1(bs, bh)
    assert p == 1.0 and np.isclose(r, 2 / 3)
    assert np.isclose(f1, 0.8)


def test_entry_points_raise_without_cuda_unless_asked(corr_problem):
    data = corr_problem[0]
    calls = (lambda: beam.beam_search(data, k=1),
             lambda: beam.omp_greedy(data, k=1),
             lambda: path.l1_path(data, n_lambdas=2))
    for call in calls:
        if torch.cuda.is_available():
            with pytest.raises(ValueError, match="lies on"):
                call()
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()


# ---------------------------------------------------------------------------
# Parity with the JAX package (float64)
# ---------------------------------------------------------------------------

def _arrays(kind):
    if kind == "tied":
        x, t, delta = make_tied_survival(n=250, p=40, n_times=15, seed=6)
    else:
        x, t, delta, _ = make_correlated_survival(
            SyntheticSpec(n=400, p=60, k=4, rho=0.9, seed=1))
    return x.astype(np.float64), t, delta


# the beam's settings for parity (cut from the defaults to keep this fast)
BEAM = dict(k=3, beam_width=3, n_expand=5, lam2=1e-3, score_steps=4,
            finetune_sweeps=15)
SUPPORT = (np.array([3, 7, 10, 0, 0], np.int32),
           np.array([1, 1, 1, 0, 0], np.float32))
IN_SUPPORT = (1, 5)


def _score_inputs(p):
    beta = np.random.default_rng(11).standard_normal(p) * 0.1
    mask = np.zeros(p, bool)
    mask[list(IN_SUPPORT)] = True
    return beta, mask


@pytest.fixture(scope="module", params=["appendix_c", "tied"])
def reference(request):
    """Every selection function of the JAX package once per data kind."""
    x, t, delta = _arrays(request.param)
    beta, mask = _score_inputs(x.shape[1])
    with jax.enable_x64(True):
        data = jcox.prepare(x, t, delta)
        l2c, _ = jcox.lipschitz_constants(data)
        dec, b = jbeam.score_candidates(data, data.x @ jnp.asarray(beta),
                                        l2c, 1e-3, jnp.asarray(mask))
        ft = jbeam.finetune(data, jnp.asarray(SUPPORT[0]),
                            jnp.asarray(SUPPORT[1]), 1e-3, 5, n_sweeps=20)
        lmax = jpath.lambda_max(data)
        out = {
            "arrays": (x, t, delta),
            "score": (np.asarray(dec), np.asarray(b)),
            "finetune": tuple(np.asarray(v) for v in ft),
            "beam": jbeam.beam_search(data, **BEAM),
            "omp": jbeam.omp_greedy(data, k=BEAM["k"], lam2=1e-3,
                                    finetune_sweeps=15),
            "lambda_max": lmax,
            "path": jpath.l1_path(data, n_lambdas=5, lambda_min_ratio=0.1,
                                  lam2=0.01, n_iters=15),
            "adaptive": jpath.adaptive_lasso(data, 0.3 * lmax, n_iters=15),
        }
    return out


def _port_data(reference):
    return cox.prepare(*reference["arrays"], device="cpu")


@USE_KERNEL
@pytest.mark.parametrize("blocks", [1, 2])
def test_score_candidates_matches_jax(reference, use_kernel, blocks,
                                      monkeypatch):
    data = _port_data(reference)
    if blocks == 2:
        # panels of 32 columns: a second, ragged block on either data
        monkeypatch.setattr(beam, "PANEL_BYTES", data.n * 8 * 32)
    assert len(beam.column_blocks(data.n, data.p, 8)) == blocks
    beta, mask = _score_inputs(data.p)
    l2c, _ = cox.lipschitz_constants(data)
    dec, b = beam.score_candidates(data, data.x @ torch.as_tensor(beta),
                                   l2c, 1e-3, mask, use_kernel=use_kernel)
    want_dec, want_b = reference["score"]
    assert np.all(np.isneginf(dec.numpy()[list(IN_SUPPORT)]))
    np.testing.assert_allclose(dec.numpy(), want_dec, rtol=RTOL, atol=1e-9)
    np.testing.assert_allclose(b.numpy(), want_b, rtol=RTOL, atol=1e-12)


@USE_KERNEL
def test_finetune_matches_jax(reference, use_kernel):
    data = _port_data(reference)
    got = beam.finetune(data, *SUPPORT, 1e-3, 5, n_sweeps=20,
                        use_kernel=use_kernel)
    for g, w, what in zip(got, reference["finetune"],
                          ("beta_s", "eta", "loss")):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=1e-12,
                                   err_msg=what)
    assert got[0].shape == (5,) and float(got[0][3:].abs().sum()) == 0.0


@pytest.mark.parametrize("given_l2", [False, True], ids=["lipschitz", "l2c"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("kind", ["appendix_c", "tied"])
def test_finetune_batch_matches_per_candidate_finetunes(kind, dtype,
                                                        given_l2):
    """Several supports of one size finetuned at once (the kernels' entry,
    their plain versions here) against each finetuned alone on the plain
    route: within 1e-8 in float64 and float32's 2e-5 (the two take L2 and
    (g, h) in different summation orders)."""
    x, t, delta = _arrays(kind)
    data = cox.prepare(x.astype(dtype), t, delta, device="cpu")
    supports = np.array([[3, 7, 10], [0, 7, 12], [1, 2, 30], [5, 6, 7]])
    l2c = cox.lipschitz_constants(data)[0] if given_l2 else None
    betas, etas, losses = beam.finetune_batch(data, supports, 1e-3,
                                              n_sweeps=20, l2c=l2c)
    assert betas.shape == (4, 3) and etas.shape == (4, data.n)
    assert losses.shape == (4,)
    rtol = RTOL if dtype == np.float64 else 2e-5
    for r, supp in enumerate(supports):
        beta, eta, loss = beam.finetune(data, supp, np.ones(3), 1e-3, 3,
                                        n_sweeps=20, use_kernel=False)
        np.testing.assert_allclose(losses[r].item(), loss.item(), rtol=rtol)
        for g, w in ((betas[r], beta), (etas[r], eta)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol,
                                       atol=rtol * float(w.abs().max()))


def _same_results(got, want):
    assert [s.tolist() for s in got.supports] == \
        [s.tolist() for s in want.supports]
    np.testing.assert_allclose(got.losses, want.losses, rtol=RTOL)
    for g, w in zip(got.betas, want.betas):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=BETA32_RTOL, atol=1e-7)


@USE_KERNEL
def test_beam_search_matches_jax(reference, use_kernel):
    got = beam.beam_search(_port_data(reference), use_kernel=use_kernel,
                           device="cpu", **BEAM)
    _same_results(got, reference["beam"])


@USE_KERNEL
def test_omp_greedy_matches_jax(reference, use_kernel):
    got = beam.omp_greedy(_port_data(reference), k=BEAM["k"], lam2=1e-3,
                          finetune_sweeps=15, use_kernel=use_kernel,
                          device="cpu")
    _same_results(got, reference["omp"])


@USE_KERNEL
def test_paths_match_jax(reference, use_kernel):
    data = _port_data(reference)
    lmax = path.lambda_max(data)
    np.testing.assert_allclose(lmax, reference["lambda_max"], rtol=RTOL)
    got = path.l1_path(data, n_lambdas=5, lambda_min_ratio=0.1, lam2=0.01,
                       n_iters=15, use_kernel=use_kernel, device="cpu")
    want = reference["path"]
    np.testing.assert_allclose(got.lambdas, want.lambdas, rtol=RTOL)
    np.testing.assert_allclose(got.betas, want.betas, rtol=RTOL, atol=1e-10)
    np.testing.assert_allclose(got.losses, want.losses, rtol=RTOL)
    np.testing.assert_array_equal(got.support_sizes, want.support_sizes)
    ada = path.adaptive_lasso(data, 0.3 * lmax, n_iters=15,
                              use_kernel=use_kernel, device="cpu")
    np.testing.assert_allclose(ada, reference["adaptive"], rtol=RTOL,
                               atol=1e-10)
