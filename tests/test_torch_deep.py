"""Port's survival/head.py and survival/deep.py: the deep-survival serving
path (featurize -> beam-search refit -> Breslow artifact -> RiskService)
held against the JAX package on the same numpy inputs, with the
reference's backbone and head params carried across by
``convert.model_params_from_jax``, and the reference's own checks of the
exported artifact (tests/test_deep.py) on the port, served through the
port's RiskService on the CPU.

Tolerances: float32 features and risks within F32_RTOL = 1e-5 of the
reference (max |port - ref| <= F32_RTOL * max |ref|; observed ~1e-6);
the refit's supports equal at every size, its float32 beta within 1e-5
relative and the artifact's baseline within 1e-5 (float32 scans in two
libraries); under x64 the losses within 1e-8 relative and the betas, cast
to float32 in both, within float32's 1e-6. Served risks equal
exp(clip(f @ beta, -30, 30)) within the reference's rtol 1e-4."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.pipeline import SurvivalTextStream as JStream  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serving import SurvivalModel as JModel  # noqa: E402
from repro.survival import deep as jdeep  # noqa: E402
from repro.survival import head as jhead  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data.pipeline import (SurvivalTextStream,  # noqa: E402
                                       put_batch)
from repro_torch.data.synthetic import make_tied_survival  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import (ModelRegistry, RiskService,  # noqa: E402
                                 ScoringEngine, SurvivalModel)
from repro_torch.survival import deep, head  # noqa: E402

F32_RTOL = 1e-5
F64_RTOL = 1e-8
BETA32_RTOL = 1e-6
SERVE_RTOL = 1e-4
SEQ, BATCH, START, N_BATCHES, K = 20, 16, 16, 4, 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on the machine's cores, and these small models' ops gain
    nothing from more threads than that."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= rtol, f"max |port - ref| / max |ref| = {err:.3e}"


@pytest.fixture(scope="module")
def models():
    """The reference's reduced deep-survival backbone (mamba2-130m) with
    its head, and the port's model holding the same weights."""
    dcfg = jdeep.DeepSurvivalConfig(seq=SEQ, batch=BATCH)
    jcfg = jdeep.model_config(dcfg)
    cfg = deep.model_config(deep.DeepSurvivalConfig(seq=SEQ, batch=BATCH))
    jm = jbuild(jcfg)
    jstate = jdeep.init_state(jm, 0)
    m = deep.init_state(Model(cfg, device="cpu"), 0).model
    m.load_state_dict(convert.model_params_from_jax(
        cfg, jax.tree.map(np.asarray, jstate.params)))
    return jm, jstate, m, cfg


@pytest.fixture(scope="module")
def held(models):
    """Held-out features from both packages' collect_features."""
    jm, jstate, m, cfg = models
    want = jdeep.collect_features(
        jm, jstate, JStream(cfg.vocab_size, SEQ, BATCH, seed=0), START,
        N_BATCHES)
    got = deep.collect_features(
        m, SurvivalTextStream(cfg.vocab_size, SEQ, BATCH, seed=0), START,
        N_BATCHES)
    return want, got


@pytest.fixture(scope="module")
def refit(held):
    """Both packages' refit_and_export on the reference's features."""
    want, _ = held
    args = (want["features"], want["time"], want["event"])
    return (jdeep.refit_and_export(*args, k=K),
            deep.refit_and_export(*args, k=K, device="cpu"))


# ---------------------------------------------------------------------------
# configs and state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-130m", "qwen2.5-3b"])
@pytest.mark.parametrize("full", [False, True])
def test_model_config_matches(arch, full):
    got = deep.model_config(deep.DeepSurvivalConfig(arch=arch, full=full))
    want = jdeep.model_config(jdeep.DeepSurvivalConfig(arch=arch, full=full))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_deep_config_defaults_match():
    """Every knob the port keeps has the reference's name and default."""
    got = dataclasses.asdict(deep.DeepSurvivalConfig())
    want = dataclasses.asdict(jdeep.DeepSurvivalConfig())
    assert set(got) <= set(want)
    assert got == {name: want[name] for name in got}


def test_config_override_and_full_path():
    """tests/test_deep.py::test_config_override_and_full_path on the port;
    the full path is mamba2-130m's published widths at 12 layers."""
    cfg = deep.model_config(deep.DeepSurvivalConfig(full=True))
    assert cfg.n_layers == 12 and cfg.vocab_size == 2048
    assert (cfg.d_model, cfg.ssm_expand, cfg.ssm_state, cfg.ssm_head_dim,
            cfg.ssm_chunk, cfg.dtype) == (768, 2, 128, 64, 128, "bfloat16")
    reduced = deep.model_config(deep.DeepSurvivalConfig())
    assert reduced.d_model == 128 and reduced.vocab_size == 512


def test_init_state_is_seeded_and_attaches_the_head():
    cfg = deep.model_config(deep.DeepSurvivalConfig())
    a = deep.init_state(Model(cfg, device="cpu"), 5).model
    b = deep.init_state(Model(cfg, device="cpu"), 5).model
    c = deep.init_state(Model(cfg, device="cpu"), 6).model
    assert a.cox_head["w"].shape == (cfg.d_model, 1)
    assert a.cox_head["b"].shape == () and a.cox_head["b"].item() == 0.0
    assert a.cox_head["w"].std().item() == pytest.approx(0.01, rel=0.3)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["cox_head.w"], sc["cox_head.w"])
    assert not torch.equal(sa["layers.0.mamba.w_in"],
                           sc["layers.0.mamba.w_in"])


def test_risk_scores_need_a_head():
    cfg = deep.model_config(deep.DeepSurvivalConfig())
    m = Model(cfg, device="cpu")
    b = put_batch(SurvivalTextStream(cfg.vocab_size, 6, 2).batch_for_step(0),
                  "cpu")
    with pytest.raises(ValueError, match="init_state"):
        m.risk_scores(b)


# ---------------------------------------------------------------------------
# the head
# ---------------------------------------------------------------------------

def _tied(n=60, seed=0):
    x, t, delta = make_tied_survival(n=n, p=3, seed=seed)
    eta = np.random.default_rng(seed + 1).normal(size=n)
    return eta, t, delta


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cox_partial_likelihood_on_tied_times(dtype):
    eta, t, delta = (a.astype(dtype) for a in _tied())
    assert len(np.unique(t)) < len(t)
    with jax.enable_x64(dtype == "float64"):
        want = float(jhead.cox_partial_likelihood(
            jnp.asarray(eta), jnp.asarray(t), jnp.asarray(delta)))
    got = head.cox_partial_likelihood(torch.from_numpy(eta),
                                      torch.from_numpy(t),
                                      torch.from_numpy(delta))
    assert got.dtype == getattr(torch, dtype)
    assert_close(float(got), want,
                 F64_RTOL if dtype == "float64" else F32_RTOL)


def test_cox_loss_and_pooled_features_match(models):
    jm, jstate, m, cfg = models
    b = JStream(cfg.vocab_size, SEQ, BATCH, seed=4).batch_for_step(2)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want, parts = jhead.cox_loss(jm, jstate.params, jb)
    with torch.no_grad():
        tb = put_batch(b, "cpu")
        got, got_parts = head.cox_loss(m, tb)
        feats = head.pooled_features(m, tb)
    assert_close(float(got), float(want), F32_RTOL)
    assert_close(float(got_parts["cox_nll"]), float(parts["cox_nll"]),
                 F32_RTOL)
    assert feats.dtype == torch.float32
    assert_close(feats.numpy(), jhead.pooled_features(jm, jstate.params, jb),
                 F32_RTOL)


# ---------------------------------------------------------------------------
# featurize, refit, export
# ---------------------------------------------------------------------------

def test_make_featurizer_matches(models):
    jm, jstate, m, cfg = models
    b = SurvivalTextStream(cfg.vocab_size, SEQ, BATCH, seed=0) \
        .batch_for_step(START)
    want_r, want_f = jdeep.make_featurizer(jm)(jstate.params, b)
    got_r, got_f = deep.make_featurizer(m)(b)
    assert got_r.dtype == got_f.dtype == torch.float32
    assert got_f.shape == (BATCH, cfg.d_model)
    assert_close(got_f.numpy(), want_f, F32_RTOL)
    assert_close(got_r.numpy(), want_r, F32_RTOL)
    # one backbone pass gives both: the risk is Model.risk_scores'
    with torch.no_grad():
        risk, _ = m.risk_scores(put_batch(b, "cpu"))
    np.testing.assert_array_equal(got_r.numpy(), risk.numpy())


def test_collect_features_matches(held):
    want, got = held
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["time"], want["time"])
    np.testing.assert_array_equal(got["event"], want["event"])
    assert got["features"].shape == (BATCH * N_BATCHES, 128)
    assert_close(got["features"], want["features"], F32_RTOL)
    assert_close(got["risk_deep"], want["risk_deep"], F32_RTOL)


def test_refit_and_export_matches(refit):
    (jb, jbeta, jart), (tb, tbeta, tart) = refit
    assert [s.tolist() for s in tb.supports] \
        == [s.tolist() for s in jb.supports]
    assert_close(tb.losses, jb.losses, F32_RTOL)
    assert tbeta.dtype == np.float32
    assert_close(tbeta, jbeta, F32_RTOL)
    for field in ("time_grid", "base_cumhaz", "beta_support"):
        assert_close(getattr(tart, field), getattr(jart, field), F32_RTOL)
    np.testing.assert_array_equal(tart.support, jart.support)
    assert tart.n_grid == jart.n_grid == 64


def test_refit_and_export_matches_in_float64(held):
    want, _ = held
    args = [a.astype(np.float64) for a in
            (want["features"], want["time"], want["event"])]
    with jax.enable_x64(True):
        jb, jbeta, jart = jdeep.refit_and_export(*args, k=K)
    tb, tbeta, tart = deep.refit_and_export(*args, k=K, device="cpu")
    assert [s.tolist() for s in tb.supports] \
        == [s.tolist() for s in jb.supports]
    assert_close(tb.losses, jb.losses, F64_RTOL)
    assert_close(tbeta, jbeta, BETA32_RTOL)
    assert_close(tart.base_cumhaz, jart.base_cumhaz, F32_RTOL)


def test_refit_defaults_to_the_card(held):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    want, _ = held
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deep.refit_and_export(want["features"], want["time"],
                              want["event"], k=K)


# ---------------------------------------------------------------------------
# the reference's checks of the artifact (tests/test_deep.py) on the port
# ---------------------------------------------------------------------------

def test_sparse_head_is_k_sparse(refit, models):
    _, (tb, tbeta, _) = refit
    nnz = int((np.abs(tbeta) > 1e-8).sum())
    assert nnz <= K
    assert tbeta.shape == (models[3].d_model,)
    assert len(tb.supports[-1]) == nnz


def test_artifact_shape_and_sparsity(refit, models):
    _, (tb, tbeta, art) = refit
    nnz = int((np.abs(tbeta) > 1e-8).sum())
    assert art.p == models[3].d_model
    assert art.is_sparse and art.k == nnz
    assert art.base_cumhaz.shape == (1, art.n_grid)
    assert (art.base_cumhaz >= 0).all()
    assert (np.diff(art.base_cumhaz, axis=1) >= -1e-6).all()


def test_artifact_roundtrip_and_serving(refit, held, tmp_path):
    _, (_, beta, art) = refit
    _, got = held
    feats = got["features"]
    path = str(tmp_path / "deep_artifact")
    art.save(path)
    loaded = SurvivalModel.load(path)
    np.testing.assert_array_equal(loaded.beta, art.beta)
    # the port's artifact loads in the reference too
    np.testing.assert_array_equal(JModel.load(path).beta, art.beta)

    svc = RiskService(None, max_batch=8)
    reg = ModelRegistry(svc, prewarm_batches=(1, 8),
                        engine_factory=lambda mdl: ScoringEngine(
                            mdl, device="cpu"))
    reg.rollout("deep_v1", path)
    svc.start()
    try:
        rids = [svc.submit(f) for f in feats[:8]]
        served = np.array([svc.wait(r, timeout=60.0).risk for r in rids])
    finally:
        svc.stop()
    expect = np.exp(np.clip(feats[:8] @ beta, -30., 30.))
    np.testing.assert_allclose(served, expect, rtol=SERVE_RTOL)
    assert reg.get("deep_v1").state == "live"
    direct, _, _ = reg.engine().score(feats[:8], with_curves=True)
    np.testing.assert_allclose(served, direct, rtol=1e-6)


def test_featurizer_matches_collected_features(models, held):
    """tests/test_deep.py::test_featurizer_matches_collected_features on
    the port: a fresh featurizer on the first held-out batch gives what
    collect_features gathered."""
    _, _, m, cfg = models
    _, got = held
    featurize = deep.make_featurizer(m)
    b = SurvivalTextStream(cfg.vocab_size, SEQ, BATCH, seed=0) \
        .batch_for_step(START)
    risk, feats = featurize(b)
    np.testing.assert_allclose(feats.numpy(), got["features"][:BATCH],
                               rtol=1e-5)
    np.testing.assert_allclose(risk.numpy(), got["risk_deep"][:BATCH],
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# training and deep.run (tests/test_deep.py's settings and checks)
# ---------------------------------------------------------------------------

RUN = dict(steps=16, batch=16, seq=20, k=4, refit_batches=2, log_every=0,
           warmup_steps=4)
TRAJ_RTOL = 2e-3         # 16 steps' losses: Adam moves a near-zero
                         # gradient by about +-lr whatever its last bits
                         # (observed 5e-5)
TRAINED_RTOL = 3e-2      # held-out features after those 16 steps, max
                         # |port - ref| / max |ref| (observed 1.1e-2)


@pytest.fixture(scope="module")
def run_result():
    return deep.run(device="cpu", **RUN)


def test_deep_config_has_every_reference_knob():
    got = dataclasses.asdict(deep.DeepSurvivalConfig())
    want = dataclasses.asdict(jdeep.DeepSurvivalConfig())
    assert got == want


def test_run_training_losses_finite_and_improving(run_result):
    assert len(run_result.losses) == 16
    assert np.isfinite(run_result.losses).all()
    assert np.mean(run_result.losses[-4:]) \
        < np.mean(run_result.losses[:4]) + 0.05


def test_run_state_is_the_trained_train_state(run_result):
    st = run_result.state
    assert st.opt.step == 16
    assert st.model.cox_head is not None
    assert sorted(st.opt.m) == sorted(dict(st.model.named_parameters()))
    assert all(v.dtype == torch.float32 for v in st.opt.v.values())


def test_run_sparse_head_is_k_sparse(run_result):
    assert run_result.nnz <= 4
    assert run_result.beta.shape == (run_result.cfg.d_model,)
    assert len(run_result.beam.supports[-1]) == run_result.nnz


def test_run_cindexes_beat_random(run_result):
    assert run_result.cindex_deep > 0.5
    assert run_result.cindex_sparse > 0.5


def test_run_artifact_shape_and_sparsity(run_result):
    art = run_result.artifact
    assert art.p == run_result.cfg.d_model
    assert art.is_sparse and art.k == run_result.nnz
    assert art.base_cumhaz.shape == (1, art.n_grid)
    assert (art.base_cumhaz >= 0).all()
    assert (np.diff(art.base_cumhaz, axis=1) >= -1e-6).all()


def test_run_artifact_roundtrip_and_serving(run_result, tmp_path):
    path = str(tmp_path / "deep_artifact")
    run_result.artifact.save(path)
    loaded = SurvivalModel.load(path)
    np.testing.assert_array_equal(loaded.beta, run_result.artifact.beta)
    svc = RiskService(None, max_batch=8)
    reg = ModelRegistry(svc, prewarm_batches=(1, 8),
                        engine_factory=lambda mdl: ScoringEngine(
                            mdl, device="cpu"))
    reg.rollout("deep_v1", path)
    svc.start()
    try:
        rids = [svc.submit(f) for f in run_result.features[:8]]
        served = np.array([svc.wait(r, timeout=60.0).risk for r in rids])
    finally:
        svc.stop()
    expect = np.exp(np.clip(run_result.features[:8] @ run_result.beta,
                            -30., 30.))
    np.testing.assert_allclose(served, expect, rtol=SERVE_RTOL)
    assert reg.get("deep_v1").state == "live"


def test_run_featurizer_matches_collected_features(run_result):
    featurize = deep.make_featurizer(run_result.state.model)
    b = SurvivalTextStream(run_result.cfg.vocab_size, 20, 16,
                           seed=0).batch_for_step(16)
    risk, feats = featurize(b)
    np.testing.assert_allclose(feats.numpy(), run_result.features[:16],
                               rtol=1e-5)
    np.testing.assert_allclose(risk.numpy(), run_result.risks_deep[:16],
                               rtol=1e-5)


def test_run_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deep.run(**RUN)


def test_train_backbone_matches_reference():
    """From the reference's initial state (carried across by
    ``train_state_from_jax``): the 16 steps' losses step by step, and the
    held-out features and c-indexes of the reference's ``deep.run``."""
    want = jdeep.run(**RUN)
    dcfg = deep.DeepSurvivalConfig(**RUN)
    cfg = deep.model_config(dcfg)
    jstate = jdeep.init_state(jbuild(jdeep.model_config(
        jdeep.DeepSurvivalConfig(**RUN))), dcfg.seed)
    st = convert.train_state_from_jax(
        cfg, jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.opt), device="cpu")
    seen = []
    st, losses, stream = deep.train_backbone(
        st.model, dcfg, state=st, on_step=lambda s, m: seen.append(s))
    assert seen == list(range(16)) and st.opt.step == 16
    np.testing.assert_allclose(losses, want.losses, rtol=TRAJ_RTOL)
    held = deep.collect_features(st.model, stream, dcfg.steps,
                                 dcfg.refit_batches)
    np.testing.assert_array_equal(held["time"], want.times)
    assert_close(held["features"], want.features, TRAINED_RTOL)
    assert want.cindex_deep > 0.5 and want.cindex_sparse > 0.5
