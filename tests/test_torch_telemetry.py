"""Solver telemetry in the port's fit functions: the reference's checks
(tests/test_obs.py's solver-convergence section) against the port, parity
of every recorded iteration with the JAX package's in float64 (1e-8
relative), and ``telemetry=None`` costing nothing on the kernel path."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import cox as jcox  # noqa: E402
from repro.core import solvers as jsolvers  # noqa: E402
from repro.obs import TelemetryCallback as JTelemetryCallback  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro_torch.core import cox, solvers  # noqa: E402
from repro_torch.data.synthetic import (SyntheticSpec,  # noqa: E402
                                        make_correlated_survival)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.obs import (TelemetryCallback, events,  # noqa: E402
                             metrics, trace)

RTOL = 1e-8


@pytest.fixture
def sinks_off():
    """Both global sinks off for the test, and after it."""
    events.configure(None)
    trace.configure(None)
    yield
    events.configure(None)
    trace.configure(None)


def _small_arrays():
    return make_correlated_survival(
        SyntheticSpec(n=200, p=15, k=3, rho=0.3, seed=4))[:3]


@pytest.fixture(scope="module")
def small_problem():
    return cox.prepare(*_small_arrays(), device="cpu")


@pytest.mark.parametrize("use_kernel", [True, False])
def test_fit_cd_telemetry_matches_objective_and_no_violations(
        small_problem, sinks_off, use_kernel):
    reg = metrics.Registry()
    tel = TelemetryCallback("cd_quad", registry=reg)
    res = solvers.fit_cd(small_problem, lam2=0.1, n_iters=20,
                         use_kernel=use_kernel, telemetry=tel, device="cpu")
    assert tel.iterations == 20
    assert tel.violations == 0
    np.testing.assert_allclose(tel.objectives, res.objective.numpy(),
                               rtol=1e-5)
    assert np.all(np.diff(tel.objectives) <= tel.tol)
    assert reg.counter("solver_iterations_total",
                       label_names=("solver",)).value(solver="cd_quad") == 20


@pytest.mark.parametrize("use_kernel", [True, False])
def test_fit_cd_tol_telemetry_counts_iterations(small_problem, sinks_off,
                                                use_kernel):
    tel = TelemetryCallback("cd_tol", registry=metrics.Registry())
    res = solvers.fit_cd_tol(small_problem, 0.0, 0.1, max_iters=30,
                             use_kernel=use_kernel, telemetry=tel,
                             device="cpu")
    assert 1 <= tel.iterations <= 30
    assert tel.iterations == res.n_iters
    assert tel.violations == 0
    rec = tel.records[0]
    assert {"iter", "objective", "grad_norm", "step_norm",
            "active_set"} <= set(rec)


def _blow_up_arrays():
    """Rare, heavy-tailed features (tests/test_solvers.py's Fig. 1a data):
    raw Newton overshoots from beta = 0."""
    rng = np.random.default_rng(1)
    n, p = 120, 4
    x = ((rng.uniform(size=(n, p)) < 0.04)
         * rng.lognormal(1.5, 1.0, size=(n, p))).astype(np.float64)
    risk = np.clip(x @ np.array([3.0, -3.0, 2.0, -2.0]), -30, 30)
    t = (-np.log(rng.uniform(1e-12, 1, n)) / np.exp(risk)) ** 0.3
    delta = (rng.uniform(size=n) < 0.8).astype(np.float64)
    return x, t, delta


def test_newton_without_line_search_is_caught(sinks_off):
    """The broken solver the paper critiques is what the violation counter
    must flag."""
    data = cox.prepare(*_blow_up_arrays(), device="cpu")
    tel = TelemetryCallback("newton_raw", registry=metrics.Registry())
    res = solvers.fit_newton(data, lam2=0.0, n_iters=12, line_search=False,
                             telemetry=tel, device="cpu")
    assert tel.iterations == 12 and res.objective.shape == (12,)
    assert tel.violations >= 1


def test_telemetry_none_is_free(small_problem, monkeypatch):
    """``telemetry=None`` computes no gradient, copies no beta, reads
    nothing on the host, and dispatches the kernels exactly as before:
    cox_coord p x sweeps times, lipschitz once."""
    def forbidden(*args, **kwargs):
        raise AssertionError("called without telemetry")

    dispatch = ops._M_DISPATCH
    before = {k: dispatch.value(kernel=k, route="plain")
              for k in ("cox_coord", "lipschitz")}
    with monkeypatch.context() as m:
        m.setattr(cox, "grad_all", forbidden)
        for name in ("clone", "item", "__float__", "tolist", "numpy",
                     "cpu"):
            m.setattr(torch.Tensor, name, forbidden)
        res = solvers.fit_cd(small_problem, lam2=0.1, n_iters=5,
                             telemetry=None, device="cpu")
    assert np.isfinite(float(res.objective[-1]))
    launched = {k: dispatch.value(kernel=k, route="plain") - v
                for k, v in before.items()}
    assert launched == {"cox_coord": small_problem.p * 5, "lipschitz": 1}


def test_solver_events_emitted(tmp_path, small_problem, sinks_off):
    path = str(tmp_path / "solver_events.jsonl")
    events.configure(path)
    try:
        tel = TelemetryCallback("evt", registry=metrics.Registry())
        solvers.fit_cd(small_problem, lam2=0.1, n_iters=5, telemetry=tel,
                       device="cpu")
    finally:
        events.configure(None)
    iters = [r for r in events.read_jsonl(path)
             if r["kind"] == "solver.iter"]
    assert len(iters) == 5
    assert all(r["solver"] == "evt" for r in iters)


# ---------------------------------------------------------------------------
# Every iteration recorded as the JAX package records it (float64)
# ---------------------------------------------------------------------------

_FITS = {
    "fit_cd": dict(lam1=0.3, lam2=0.5, n_iters=6),
    "fit_cd_tol": dict(lam1=0.3, lam2=0.5, max_iters=8, tol=0.0),
    "fit_newton": dict(lam2=1.0, n_iters=4, line_search=True),
    "fit_working_newton": dict(lam1=0.3, lam2=0.5, n_iters=4),
    "fit_gd": dict(lam1=0.3, lam2=0.5, n_iters=6),
}


@pytest.mark.parametrize("name", sorted(_FITS))
def test_telemetry_records_match_jax(name, sinks_off):
    x, t, delta = _small_arrays()
    x = x.astype(np.float64)
    kw = _FITS[name]
    with jax.enable_x64(True):
        jtel = JTelemetryCallback(name, registry=jmetrics.Registry())
        jres = getattr(jsolvers, name)(jcox.prepare(x, t, delta),
                                       telemetry=jtel, **kw)
        jres.beta.block_until_ready()
        jax.effects_barrier()
        want, want_obj = jtel.records, np.asarray(jres.objective)
    tel = TelemetryCallback(name, registry=metrics.Registry())
    res = getattr(solvers, name)(cox.prepare(x, t, delta, device="cpu"),
                                 telemetry=tel, device="cpu", **kw)
    got = tel.records
    assert [r["iter"] for r in got] == [r["iter"] for r in want]
    assert [r["active_set"] for r in got] == [r["active_set"] for r in want]
    np.testing.assert_allclose(res.objective.numpy()[-1], want_obj[-1],
                               rtol=RTOL)
    # the JAX package's fit_newton hands its callback values rounded to
    # float32 (its objective trace is float64): held at float32's 1e-6
    rtol = 1e-6 if name == "fit_newton" else RTOL
    for key in ("objective", "grad_norm", "step_norm"):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in want], rtol=rtol,
                                   atol=1e-10, err_msg=key)
