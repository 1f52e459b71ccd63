"""Port's core/streaming.py, solvers.fit_stream and obs/solver.py against the
JAX package on the same numpy chunks, and the reference's own checks
(tests/test_streaming.py, tests/test_obs.py).

The port's use_kernel=True route takes the kernels' plain versions here
(the tensors lie on the CPU); chip_smoke.py holds the CUDA kernels against
those on the card. Both routes are held against the JAX functions with
use_kernel=False. Tolerances: float32 2e-4 (sums over up to 1,000 rows in
different orders, as tests/test_streaming.py allows); float64 1e-8
relative."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import solvers as jsolvers  # noqa: E402
from repro.core import streaming as jstreaming  # noqa: E402
from repro_torch.core import cox, solvers, streaming  # noqa: E402
from repro_torch.obs import TelemetryCallback, metrics  # noqa: E402
from repro_torch.obs import solver as obs_solver  # noqa: E402

TOL = {np.float32: 2e-4, np.float64: 1e-8}


def _sorted_problem(n, p, seed, dtype=np.float32):
    """Time-sorted, tie-free rows (x, delta): row order is time order."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, p)).astype(dtype)
    delta = (rng.uniform(size=n) < 0.7).astype(dtype)
    return x, delta


def _bounds(n, chunk_rows):
    return [(lo, min(lo + chunk_rows, n)) for lo in range(0, n, chunk_rows)]


def _sources(x, delta, chunk_rows):
    """The same chunks for both packages: (JAX list, port list)."""
    jsrc = [jstreaming.Chunk(x=jnp.asarray(x[a:b]), delta=jnp.asarray(
        delta[a:b])) for a, b in _bounds(len(x), chunk_rows)]
    tsrc = [streaming.Chunk(x=torch.from_numpy(x[a:b].copy()),
                            delta=torch.from_numpy(delta[a:b].copy()))
            for a, b in _bounds(len(x), chunk_rows)]
    return jsrc, tsrc


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# chunked suffix-sum carry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ndim", [1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunked_revcumsum_random_boundaries(seed, ndim, dtype):
    rng = np.random.default_rng(seed)
    n = 777
    v = rng.standard_normal((n,) if ndim == 1 else (n, 5)).astype(dtype)
    k = rng.integers(1, 7)
    edges = [0] + sorted(rng.choice(np.arange(1, n), size=k,
                                    replace=False)) + [n]
    pairs = list(zip(edges[:-1], edges[1:]))
    with jax.enable_x64(dtype == np.float64):
        want = np.concatenate([np.asarray(o) for o in
                               jstreaming.chunked_revcumsum(
                                   [jnp.asarray(v[a:b]) for a, b in pairs],
                                   use_kernel=False)])
    segs = [torch.from_numpy(v[a:b].copy()) for a, b in pairs]
    for use_kernel in (True, False):
        got = torch.cat(streaming.chunked_revcumsum(segs, use_kernel))
        assert got.dtype == torch.from_numpy(v).dtype
        _close(got, want, TOL[dtype])
    mono = cox.revcumsum(torch.from_numpy(v), 0)
    _close(torch.cat(streaming.chunked_revcumsum(segs)), mono, TOL[dtype])


# ---------------------------------------------------------------------------
# streaming statistics against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("chunk_rows", [97, 250, 1000])
def test_streaming_statistics_match_jax(chunk_rows, dtype):
    x, delta = _sorted_problem(1000, 7, seed=4, dtype=dtype)
    beta = (np.random.default_rng(5).standard_normal(7) * 0.3).astype(dtype)
    tol = TOL[dtype]
    with jax.enable_x64(dtype == np.float64):
        jsrc, tsrc = _sources(x, delta, chunk_rows)
        jb = jnp.asarray(beta)
        want_gh = [np.asarray(a) for a in jstreaming.streaming_grad_hess(
            jsrc, jb, use_kernel=False)]
        want_loss = float(jstreaming.streaming_loss(jsrc, jb,
                                                    use_kernel=False))
        want_strat = [np.asarray(a) for a in jstreaming.stratified_grad_hess(
            jsrc, jb, use_kernel=False)]
        want_sloss = float(jstreaming.stratified_loss(jsrc, jb))
    tb = torch.from_numpy(beta)
    for use_kernel in (True, False):
        gh = streaming.streaming_grad_hess(tsrc, tb, use_kernel)
        for got, want in zip(gh, want_gh):
            assert got.dtype == tb.dtype
            _close(got, want, tol)
        _close(streaming.streaming_loss(tsrc, tb, use_kernel), want_loss,
               tol)
        for got, want in zip(streaming.stratified_grad_hess(
                tsrc, tb, use_kernel), want_strat):
            _close(got, want, tol)
    _close(streaming.stratified_loss(tsrc, tb), want_sloss, tol)


@pytest.mark.parametrize("chunk_rows", [97, 250, 1000])
def test_streaming_matches_monolithic(chunk_rows):
    """The reference's own check: the streamed global statistics equal the
    monolithic ones of core/cox.py on the whole tie-free panel."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1000, 7)).astype(np.float32)
    t = rng.exponential(size=1000).astype(np.float32)
    delta = (rng.uniform(size=1000) < 0.7).astype(np.float32)
    data = cox.prepare(x, t, delta, device="cpu")
    beta = torch.from_numpy(rng.standard_normal(7).astype(np.float32) * 0.3)
    src = streaming.as_chunks(data, chunk_rows)
    assert len(src) == -(-1000 // chunk_rows)
    g, h, loss = streaming.streaming_grad_hess(src, beta)
    eta = data.x @ beta
    g_r, h_r = cox.grad_hess_all(data, eta)
    _close(g, g_r, 2e-4)
    _close(h, h_r, 2e-4)
    loss_r = float(cox.loss_from_eta(data, eta))
    np.testing.assert_allclose(float(loss), loss_r, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(float(streaming.streaming_loss(src, beta)),
                               loss_r, rtol=1e-5, atol=1e-3)


def test_streaming_moves_numpy_chunks_to_the_fit_device():
    x, delta = _sorted_problem(300, 4, seed=6)
    tensors = [streaming.Chunk(x=torch.from_numpy(x[a:b].copy()),
                               delta=torch.from_numpy(delta[a:b].copy()))
               for a, b in _bounds(300, 100)]
    arrays = [streaming.Chunk(x=x[a:b], delta=delta[a:b])
              for a, b in _bounds(300, 100)]
    beta = torch.full((4,), 0.1)
    for fn in (streaming.streaming_grad_hess,
               streaming.stratified_grad_hess):
        for got, want in zip(fn(arrays, beta), fn(tensors, beta)):
            assert torch.equal(got, want)
    a = solvers.fit_stream(arrays, lam2=0.05, n_epochs=4, device="cpu")
    b = solvers.fit_stream(tensors, lam2=0.05, n_epochs=4, device="cpu")
    assert torch.equal(a.objective, b.objective)
    assert torch.equal(a.beta, b.beta)


# ---------------------------------------------------------------------------
# fit_stream against the JAX fit_stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("mode", ["global", "chunk"])
def test_fit_stream_matches_jax(mode, use_kernel):
    x, delta = _sorted_problem(640, 12, seed=11, dtype=np.float64)
    with jax.enable_x64(True):
        jsrc, tsrc = _sources(x, delta, 128)
        want = jsolvers.fit_stream(jsrc, lam1=0.5, lam2=0.05, n_epochs=6,
                                   mode=mode, use_kernel=False)
        w_obj, w_beta = np.asarray(want.objective), np.asarray(want.beta)
        w_iters = int(want.n_iters)
    got = solvers.fit_stream(tsrc, lam1=0.5, lam2=0.05, n_epochs=6,
                             mode=mode, use_kernel=use_kernel, device="cpu")
    assert got.n_iters == w_iters and got.objective.shape == w_obj.shape
    assert got.beta.dtype == torch.float64
    np.testing.assert_allclose(got.objective.numpy(), w_obj, rtol=1e-8)
    np.testing.assert_allclose(got.beta.numpy(), w_beta, rtol=1e-8,
                               atol=1e-10)


# ---------------------------------------------------------------------------
# The reference's own fit_stream checks (tests/test_streaming.py)
# ---------------------------------------------------------------------------

def _make_data(n, p, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, p)).astype(np.float32)
    t = rng.exponential(size=n).astype(np.float32)   # continuous: tie-free
    delta = (rng.uniform(size=n) < 0.7).astype(np.float32)
    return cox.prepare(x, t, delta, device="cpu")


@pytest.mark.parametrize("chunk_rows", [None, 128])
def test_fit_stream_global_matches_fit_cd(chunk_rows):
    """One full-size chunk, or several, converge to fit_cd's objective."""
    data = _make_data(600, 6, seed=7 if chunk_rows is None else 8)
    res_cd = solvers.fit_cd(data, lam1=0.02, lam2=0.01, n_iters=200,
                            device="cpu")
    src = streaming.as_chunks(data, chunk_rows or data.n)
    res_st = solvers.fit_stream(src, lam1=0.02, lam2=0.01, n_epochs=500,
                                tol=1e-10, device="cpu")
    f_cd = float(res_cd.objective[-1])
    f_st = float(res_st.objective[-1])
    assert abs(f_st - f_cd) <= 1e-4 * abs(f_cd), (f_st, f_cd)


def test_fit_stream_chunk_mode_descends_zero_violations():
    data = _make_data(512, 5, seed=9)
    src = streaming.as_chunks(data, 128)
    tel = TelemetryCallback(solver="fit_stream_test",
                            registry=metrics.Registry())
    res = solvers.fit_stream(src, lam2=0.05, n_epochs=25, mode="chunk",
                             telemetry=tel, device="cpu")
    obj = res.objective.numpy()
    assert np.all(np.diff(obj) <= 1e-6), obj
    assert tel.violations == 0
    assert tel.iterations >= 1
    np.testing.assert_array_equal(tel.objectives, obj[:tel.iterations])


def test_fit_stream_rejects_unknown_mode_and_missing_card():
    data = _make_data(64, 3, seed=10)
    src = streaming.as_chunks(data, 32)
    with pytest.raises(ValueError, match="unknown mode"):
        solvers.fit_stream(src, mode="nope", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            solvers.fit_stream(src, n_epochs=1)


# ---------------------------------------------------------------------------
# obs/solver.py (tests/test_obs.py's checks)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [(0, 1, 2, 3), (2, 0, 3, 1)])
def test_telemetry_counts_one_violation_in_any_arrival_order(order):
    tel = TelemetryCallback("broken", tol=1e-6, registry=metrics.Registry())
    seq = {0: 5.0, 1: 4.0, 2: 4.5, 3: 3.0}   # one rise: 4 -> 4.5
    for it in order:
        obs_solver.emit_iter(tel, torch.tensor(it), torch.tensor(seq[it]),
                             0.0, torch.tensor(0.0), torch.tensor(2))
    assert tel.violations == 1 and tel.iterations == 4
    assert tel.records[2] == {"iter": 2, "objective": 4.5, "grad_norm": 0.0,
                              "step_norm": 0.0, "active_set": 2}
    tel.reset()
    assert tel.iterations == 0 and tel.violations == 1


def test_emit_iter_without_callback_reads_nothing():
    class Unreadable:
        def item(self):
            raise AssertionError("read without a callback")

    obs_solver.emit_iter(None, *([Unreadable()] * 5))
