"""Port's serving/: the Breslow/Efron artifact, save/load in both directions
between the packages, and the ScoringEngine, against the JAX package and
against the reference's own checks (tests/test_serving.py).

The artifact is float32 by the reference's contract (it casts its inputs),
so the baselines of the two packages are compared at 2e-6 relative: the
same float32 cumulative sums, taken in different orders. Curves and risks
go through float32 matmuls on both sides: 1e-5."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import ScoringEngine as JEngine  # noqa: E402
from repro.serving import SurvivalModel as JModel  # noqa: E402
from repro.serving import fit_survival_model as j_fit  # noqa: E402
from repro.survival import metrics  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data.synthetic import make_tied_survival  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import (ArtifactCorrupt, ScoringEngine,  # noqa: E402
                                 SurvivalModel, fit_survival_model)

H_RTOL = 2e-6


def _problem(n=200, p=8, seed=0, ties=True):
    if ties:
        x, t, delta = make_tied_survival(n=n, p=p, seed=seed)
    else:
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((n, p)).astype(np.float32)
        t = rng.permutation(1.0 + np.arange(n) / n).astype(np.float32)
        delta = (rng.uniform(size=n) < 0.7).astype(np.float32)
    rng = np.random.default_rng(seed + 1)
    beta = (rng.standard_normal(p) * 0.4).astype(np.float32)
    return x, t, delta, beta


def _fit(*args, **kw):
    return fit_survival_model(*args, device="cpu", **kw)


def _engine(model, **kw):
    return ScoringEngine(model, device="cpu", **kw)


def _arrays(model):
    return {f: getattr(model, f) for f in
            ("beta", "time_grid", "base_cumhaz", "support", "beta_support",
             "strata_labels")}


# ---------------------------------------------------------------------------
# The artifact against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ties_data", [True, False])
@pytest.mark.parametrize("ties", ["breslow", "efron"])
def test_baseline_matches_jax(ties_data, ties):
    x, t, delta, beta = _problem(ties=ties_data)
    got, want = _fit(x, t, delta, beta, ties=ties), \
        j_fit(x, t, delta, beta, ties=ties)
    np.testing.assert_array_equal(got.time_grid, want.time_grid)
    assert got.base_cumhaz.dtype == want.base_cumhaz.dtype == np.float32
    np.testing.assert_allclose(got.base_cumhaz, want.base_cumhaz,
                               rtol=H_RTOL, atol=1e-7)


def test_stratified_and_sparse_artifact_match_jax():
    x, t, delta, beta = _problem(n=240, p=12)
    beta[[1, 4, 9]] = 0.0
    strata = np.random.default_rng(7).integers(0, 3, size=len(t))
    got = _fit(x, t, delta, beta, strata=strata)
    want = j_fit(x, t, delta, beta, strata=strata)
    for name in ("support", "beta_support", "strata_labels", "beta"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    np.testing.assert_allclose(got.base_cumhaz, want.base_cumhaz,
                               rtol=H_RTOL, atol=1e-7)


# ---------------------------------------------------------------------------
# The reference's own artifact checks, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ties", [True, False])
def test_breslow_artifact_matches_numpy(ties):
    x, t, delta, beta = _problem(ties=ties)
    model = _fit(x, t, delta, beta)
    h = metrics.breslow_baseline(t, delta, x @ beta)
    np.testing.assert_allclose(model.base_cumhaz[0], h(model.time_grid),
                               rtol=1e-4, atol=1e-6)


def test_breslow_artifact_stratified_matches_per_stratum_numpy():
    x, t, delta, beta = _problem(n=240)
    strata = np.random.default_rng(7).integers(0, 3, size=len(t))
    model = _fit(x, t, delta, beta, strata=strata)
    assert model.n_strata == 3
    eta = x @ beta
    for s in range(3):
        m = strata == s
        h = metrics.breslow_baseline(t[m], delta[m], eta[m])
        np.testing.assert_allclose(model.base_cumhaz[s], h(model.time_grid),
                                   rtol=1e-4, atol=1e-6)


def test_efron_equals_breslow_without_ties():
    x, t, delta, beta = _problem(ties=False)
    mb = _fit(x, t, delta, beta, ties="breslow")
    me = _fit(x, t, delta, beta, ties="efron")
    np.testing.assert_allclose(me.base_cumhaz, mb.base_cumhaz, rtol=1e-5,
                               atol=1e-7)


def test_efron_baseline_larger_with_ties():
    x, t, delta, beta = _problem(ties=True)
    mb = _fit(x, t, delta, beta, ties="breslow")
    me = _fit(x, t, delta, beta, ties="efron")
    assert np.all(me.base_cumhaz >= mb.base_cumhaz - 1e-7)
    assert np.any(me.base_cumhaz > mb.base_cumhaz + 1e-6)


def test_unknown_ties_and_no_cuda_raise():
    x, t, delta, beta = _problem(n=30)
    with pytest.raises(ValueError, match="tie handling"):
        _fit(x, t, delta, beta, ties="exact")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fit_survival_model(x, t, delta, beta)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ScoringEngine(_fit(x, t, delta, beta))


# ---------------------------------------------------------------------------
# Save / load: byte-compatible with the reference, both ways
# ---------------------------------------------------------------------------

def _cases():
    x, t, delta, beta = _problem(n=160, p=12)
    beta_sparse = np.zeros_like(beta)
    beta_sparse[[2, 7]] = beta[[2, 7]]
    strata = np.random.default_rng(3).integers(0, 2, size=len(t))
    return {"dense": (x, t, delta, beta, None),
            "sparse": (x, t, delta, beta_sparse, None),
            "strat": (x, t, delta, beta, strata)}


@pytest.mark.parametrize("tag", ["dense", "sparse", "strat"])
def test_artifacts_cross_load_bitwise(tmp_path, tag):
    x, t, delta, beta, strata = _cases()[tag]
    jm = j_fit(x, t, delta, beta, strata=strata, ties="efron")
    tm = _fit(x, t, delta, beta, strata=strata, ties="efron")
    # JAX-saved -> port, port-saved -> JAX
    got_t = SurvivalModel.load(jm.save(str(tmp_path / "from_jax")))
    got_j = JModel.load(tm.save(str(tmp_path / "from_torch")))
    for src, dst in ((jm, got_t), (tm, got_j)):
        assert dst.ties == src.ties == "efron"
        for name, arr in _arrays(src).items():
            other = getattr(dst, name)
            if arr is None:
                assert other is None, name
            else:
                assert other.dtype == arr.dtype, name
                np.testing.assert_array_equal(other, arr, err_msg=name)
    # the same model writes the same bytes from either package
    same = convert.model_from_reference(_arrays(jm), jm.ties)
    a = same.save(str(tmp_path / "a"))
    b = jm.save(str(tmp_path / "b"))
    for leaf in sorted(os.listdir(a)):
        with open(os.path.join(a, leaf), "rb") as fa, \
                open(os.path.join(b, leaf), "rb") as fb:
            assert fa.read() == fb.read(), leaf


def test_load_detects_corruption_and_reads_format_1(tmp_path):
    x, t, delta, beta = _problem(n=80)
    path = _fit(x, t, delta, beta).save(str(tmp_path / "m"))
    leaf = os.path.join(path, "base_cumhaz.npy")
    with open(leaf, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))
    with pytest.raises(ArtifactCorrupt, match="base_cumhaz"):
        SurvivalModel.load(path)
    SurvivalModel.load(path, verify=False)
    man = os.path.join(path, "manifest.json")
    with open(man) as f:
        m = json.load(f)
    m["format"] = 1
    m["arrays"] = {k: {"shape": v["shape"], "dtype": v["dtype"]}
                   for k, v in m["arrays"].items()}
    with open(man, "w") as f:
        json.dump(m, f)
    assert SurvivalModel.load(path).p == 8
    os.remove(leaf)
    with pytest.raises(ArtifactCorrupt, match="missing leaf"):
        SurvivalModel.load(path)


def test_roundtrip_bitwise_curves(tmp_path):
    for tag, (x, t, delta, beta, strata) in _cases().items():
        if strata is not None:
            continue
        model = _fit(x, t, delta, beta)
        loaded = SurvivalModel.load(model.save(str(tmp_path / tag)))
        q = x[:16]
        np.testing.assert_array_equal(_engine(model).survival_curves(q),
                                      _engine(loaded).survival_curves(q),
                                      err_msg=tag)


# ---------------------------------------------------------------------------
# Engine against the JAX engine, dense and sparse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("b", [1, 13, 64])
def test_engine_score_matches_jax(sparse, b):
    x, t, delta, beta = _problem(n=150, p=40)
    if sparse:
        beta = np.zeros(40, np.float32)
        beta[[3, 17, 31]] = (0.5, -0.8, 0.3)
    jm = j_fit(x, t, delta, beta)
    tm = convert.model_from_reference(_arrays(jm), jm.ties)
    q = np.random.default_rng(b).standard_normal((b, 40)).astype(np.float32)
    want = JEngine(jm).score(q, with_curves=True)
    eng = _engine(tm)
    assert eng.use_sparse is sparse
    got = eng.score(q, with_curves=True)
    risk, med, curves = got
    assert risk.shape == (b,) and med.shape == (b,) and curves.shape == (
        b, jm.n_grid)
    np.testing.assert_allclose(risk, want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(curves, want[2], rtol=1e-5, atol=1e-6)
    # medians are grid points: equal unless a curve sits on 0.5 to 1e-5
    np.testing.assert_array_equal(med, want[1])
    short = eng.score(q)
    np.testing.assert_array_equal(short[0], risk)
    np.testing.assert_array_equal(short[1], med)


def test_engine_sparse_matches_dense_path():
    x, t, delta, beta = _problem(n=150, p=40)
    beta_s = np.zeros(40, np.float32)
    beta_s[[3, 17, 31]] = (0.5, -0.8, 0.3)
    model = _fit(x, t, delta, beta_s)
    assert model.k == 3
    q = np.random.default_rng(0).standard_normal((33, 40)).astype(np.float32)
    dense = _engine(model, use_sparse=False)
    sparse = _engine(model, use_sparse=True)
    np.testing.assert_allclose(sparse.risk_scores(q), dense.risk_scores(q),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sparse.survival_curves(q),
                               dense.survival_curves(q), rtol=1e-5, atol=1e-6)
    # pre-gathered (b, k) features hit the same path
    np.testing.assert_array_equal(sparse.risk_scores(q[:, model.support]),
                                  sparse.risk_scores(q))
    with pytest.raises(ValueError, match="features"):
        sparse.risk_scores(q[:, :5])


@pytest.mark.parametrize("ties", [True, False])
def test_engine_curves_match_closed_form(ties):
    x, t, delta, beta = _problem(ties=ties)
    model = _fit(x, t, delta, beta)
    q = x[:10]
    eta = np.clip(q @ beta, -30, 30)
    expect = np.exp(-model.base_cumhaz[0][None, :] * np.exp(eta)[:, None])
    got = _engine(model).survival_curves(q)
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6)
    # curves are nonincreasing in t
    assert np.all(np.diff(got, axis=1) <= 1e-7)


def test_engine_median_survival():
    x, t, delta, beta = _problem()
    model = _fit(x, t, delta, beta)
    eng = _engine(model)
    q = x[:20]
    med = eng.median_survival(q)
    s = eng.survival_curves(q)
    grid = model.time_grid
    for i in range(len(q)):
        below = s[i] <= 0.5
        if below.any():
            assert med[i] == grid[np.argmax(below)]
        else:
            assert np.isinf(med[i])


def test_engine_bucketed_cache_and_prewarm():
    x, t, delta, beta = _problem()
    eng = _engine(_fit(x, t, delta, beta))
    for b in (1, 2, 3, 5, 7, 9, 15, 17, 31, 33):
        eng.risk_scores(x[:b])
    # 10 distinct batch sizes collapse into pow2 buckets 1..64 -> <= 7
    info = eng.cache_info()
    assert info["entries"] <= 7 and info["compiles"] == info["entries"]
    assert info["calls"] == 10 and info["shard"] == 1
    assert eng.prewarm(batch_sizes=(1, 3, 4, 100), kinds=("score",)) == 3
    assert eng.prewarm(batch_sizes=(1, 3, 4, 100), kinds=("score",)) == 0


def test_engine_counts_curve_dispatches():
    x, t, delta, beta = _problem()
    eng = _engine(_fit(x, t, delta, beta))
    before = ops._M_DISPATCH.value(kernel="survival_curves", route="plain")
    eng.score(x[:5], with_curves=True)
    eng.median_survival(x[:5])
    eng.risk_scores(x[:5])
    after = ops._M_DISPATCH.value(kernel="survival_curves", route="plain")
    assert after == before + 2


def test_engine_unported_options_raise():
    """shard= (ROADMAP A7) is ported: on the CPU it clamps to one shard
    and scores as the unsharded engine does; stratified models score."""
    x, t, delta, beta = _problem(n=120)
    model = _fit(x, t, delta, beta)
    sharded = ScoringEngine(model, shard=2, device="cpu")
    assert sharded.shard == 1
    np.testing.assert_array_equal(sharded.risk_scores(x[:5]),
                                  _engine(model).risk_scores(x[:5]))
    strata = np.random.default_rng(0).integers(0, 2, size=len(t))
    strat = _fit(x, t, delta, beta, strata=strata)
    q, sq = x[:3], np.array([0, 1, 0])
    curves = _engine(strat).survival_curves(q, strata=sq)
    eta = np.clip(q @ beta, -30, 30)
    np.testing.assert_allclose(
        curves, np.exp(-strat.base_cumhaz[sq] * np.exp(eta)[:, None]),
        rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="stratum indices"):
        _engine(model).survival_curves(q, strata=sq)
    np.testing.assert_array_equal(
        _engine(model).survival_curves(q, strata=np.zeros(3, np.int32)),
        _engine(model).survival_curves(q))


# ---------------------------------------------------------------------------
# Stratified scoring against the JAX engine
# ---------------------------------------------------------------------------

def _stratified_models(n=300, p=10, n_strata=4):
    x, t, delta, beta = _problem(n=n, p=p, seed=3)
    strata = np.random.default_rng(5).integers(0, n_strata, size=n)
    jm = j_fit(x, t, delta, beta, strata=strata)
    return x, jm, convert.model_from_reference(_arrays(jm), jm.ties)


@pytest.mark.parametrize("b", [1, 13, 64])
def test_stratified_engine_matches_jax(b):
    x, jm, tm = _stratified_models()
    assert tm.n_strata == 4
    rng = np.random.default_rng(b)
    q = rng.standard_normal((b, 10)).astype(np.float32)
    sq = rng.integers(0, 4, b)
    jeng, eng = JEngine(jm), _engine(tm)
    want = jeng.score(q, sq, with_curves=True)
    got = eng.score(q, sq, with_curves=True)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(eng.survival_curves(q, sq),
                               jeng.survival_curves(q, sq), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(eng.median_survival(q, sq),
                                  jeng.median_survival(q, sq))
    # no strata means stratum 0 for every request, as in the reference
    np.testing.assert_allclose(eng.survival_curves(q),
                               jeng.survival_curves(q), rtol=1e-5,
                               atol=1e-6)


def test_stratified_engine_dispatches_the_stratified_kernel():
    x, _, tm = _stratified_models()
    eng = _engine(tm)
    counter = ops._M_DISPATCH
    strat0 = counter.value(kernel="survival_curves_stratified", route="plain")
    single0 = counter.value(kernel="survival_curves", route="plain")
    eng.score(x[:5], np.arange(5) % 4, with_curves=True)
    assert counter.value(kernel="survival_curves_stratified",
                         route="plain") == strat0 + 1
    assert counter.value(kernel="survival_curves", route="plain") == single0


@pytest.mark.parametrize("bad", [[0, 4, 1], [-1, 0, 0]])
def test_stratified_engine_rejects_out_of_range_strata(bad):
    x, jm, tm = _stratified_models()
    with pytest.raises(ValueError, match=r"stratum indices must be in \[0, 4\)"):
        _engine(tm).score(x[:3], np.array(bad))
    with pytest.raises(ValueError, match=r"stratum indices must be in \[0, 4\)"):
        JEngine(jm).score(x[:3], np.array(bad))


def test_stratified_engine_prewarm():
    x, _, tm = _stratified_models()
    eng = _engine(tm)
    assert eng.prewarm(batch_sizes=(1, 3, 4, 100), kinds=("score",),
                       strata=True) == 3
    assert eng.prewarm(batch_sizes=(1, 3, 4, 100), kinds=("score",),
                       strata=True) == 0
    assert eng.prewarm(batch_sizes=(5,), kinds=("score_curves",)) == 1
    info = eng.cache_info()
    assert info["compiles"] == info["entries"] == 4
