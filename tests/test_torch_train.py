"""Port's train/ (optimizer, trainer, loop, compression, fault tolerance)
and the Model's remat, held against the JAX package on the same numpy
inputs and the same weights (the reference's params and optimizer state
carried across by ``convert.train_state_from_jax``), with the torch ports
of tests/test_runtime.py and tests/test_arch_smoke.py's
test_train_grads_finite.

Tolerances, each measured as max |port - ref| against max |ref|:
  * the schedule and the bias corrections within SCHED_RTOL = 2e-7 (both
    float32; a cos or pow may round to the other neighbour);
  * ``adamw_update`` on identical params, grads and moments within
    ADAM_RTOL = 1e-6 (float32 params and moments; each elementwise step
    rounds as the reference's; the gradient norm sums in another order),
    bfloat16 params within one bfloat16 rounding, BF16_RTOL = 8e-3;
  * one step's loss within LOSS_RTOL = 1e-6 and every gradient within
    GRAD_RTOL = 2e-5 of its leaf's largest, plus GRAD_ATOL = 1e-6
    absolute: the Cox loss is invariant to a shift of eta, so the head
    bias's gradient is zero in exact arithmetic and both packages give
    rounding noise of ~1e-7 there (observed ~5e-6 relative elsewhere,
    reduced configs in float32);
  * 16-step loss trajectories within TRAJ_RTOL = 2e-3 of each step's
    loss: Adam moves a near-zero gradient by about +-lr whatever its
    size, so the packages' last-bit differences grow step by step
    (observed ~3e-4 over 8 steps); the microbatch step within the
    reference's own rtol 1e-4 of the full batch.
Remat (on, "nothing", "dots", off) gives the same bits on the CPU."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.survival.head import init_cox_head as j_init_cox_head  # noqa: E402
from repro.train import compression as jcompression  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train import compression, optimizer, trainer  # noqa: E402
from repro_torch.train import fault_tolerance as ft  # noqa: E402
from repro_torch.train.loop import run_loop  # noqa: E402

SCHED_RTOL = 2e-7
ADAM_RTOL = 1e-6
BF16_RTOL = 8e-3
LOSS_RTOL = 1e-6
GRAD_RTOL = 2e-5
GRAD_ATOL = 1e-6
TRAJ_RTOL = 2e-3
ARCHS = sorted(name for name, cfg in jconfigs.REGISTRY.items()
               if cfg.family in ("dense", "ssm"))
OTHER = sorted(name for name in jconfigs.REGISTRY if name not in ARCHS)
OBJECTIVES = ("lm", "cox")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on the machine's cores, and these small models' ops gain
    nothing from more threads than that."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(got, want, rtol, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want)) if got.size else 0.0
    scale = np.max(np.abs(want)) if want.size else 0.0
    assert err <= rtol * scale + atol, \
        f"max |port - ref| {err:.3e}, max |ref| {scale:.3e}"


def _np(t):
    return t.detach().float().cpu().numpy()


def _jtree(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(arch, objective="lm", vocab=None, seed=0):
    """(reference model, its TrainState, the port's TrainState holding the
    same weights and moments, config) at reduced_config."""
    jcfg = jconfigs.reduced_config(jconfigs.get_config(arch))
    cfg = configs.reduced_config(configs.get_config(arch))
    if vocab:
        jcfg, cfg = jcfg.scaled(vocab_size=vocab), cfg.scaled(vocab_size=vocab)
    jm = jbuild(jcfg)
    params = jm.init_params(jax.random.PRNGKey(seed))
    if objective == "cox":
        params["cox_head"] = j_init_cox_head(jax.random.PRNGKey(seed + 1),
                                             cfg.d_model)
    jstate = jtrainer.TrainState(params=params,
                                 opt=jopt.init_opt_state(params))
    st = convert.train_state_from_jax(cfg, _jtree(params),
                                      _jtree(jstate.opt), device="cpu")
    return jm, jstate, st, cfg


def _stream(objective, cfg, seq=32, batch=8, seed=0, mod=None):
    mod = mod or pipeline
    cls = mod.TokenTaskStream if objective == "lm" else mod.SurvivalTextStream
    return cls(cfg.vocab_size, seq, batch, seed=seed)


def _tcfg(**kw):
    kw = {"learning_rate": 3e-3, "warmup_steps": 5, "total_steps": 200, **kw}
    return jconfigs.TrainConfig(**kw), configs.TrainConfig(**kw)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"warmup_steps": 20, "total_steps": 150, "learning_rate": 2e-3},
    {"warmup_steps": 0, "total_steps": 1}],
    ids=["defaults", "deep", "no-warmup"])
def test_lr_schedule_matches(kw):
    jc, tc = _tcfg(**kw)
    steps = [0, 1, 2, 5, 19, 20, 21, 77, 149, 150, 151, 10_000]
    want = np.array([float(jopt.lr_schedule(jnp.int32(s), jc))
                     for s in steps], np.float32)
    got = np.array([float(optimizer.lr_schedule(s, tc)) for s in steps],
                   np.float32)
    assert all(optimizer.lr_schedule(s, tc).dtype == torch.float32
               for s in steps)
    assert_close(got, want, SCHED_RTOL)


def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": (300,), "c": (3, 4, 2), "d": ()}
    return {k: np.asarray(rng.standard_normal(s) * 0.5, dtype)
            for k, s in shapes.items()}


def test_global_norm_matches():
    tree = _tree(0)
    want = float(jopt.global_norm({k: jnp.asarray(v) for k, v in
                                   tree.items()}))
    got = optimizer.global_norm({k: torch.from_numpy(v)
                                 for k, v in tree.items()})
    assert got.dtype == torch.float32
    assert_close(float(got), want, ADAM_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 100.0], ids=["clipped", "unclipped"])
def test_adamw_update_matches(dtype, clip):
    """Identical params, grads and moments (step 3 -> 4) through both."""
    params, grads = _tree(1), _tree(2)
    m, v = _tree(3), {k: np.asarray(np.abs(a) * 0.1)
                      for k, a in _tree(4).items()}
    jc, tc = _tcfg(grad_clip=clip)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jp = {k: jnp.asarray(a).astype(jdt) for k, a in params.items()}
    jg = {k: jnp.asarray(a).astype(jdt) for k, a in grads.items()}
    jo = jopt.OptState(m={k: jnp.asarray(a) for k, a in m.items()},
                       v={k: jnp.asarray(a) for k, a in v.items()},
                       step=jnp.int32(3))
    want_p, want_o, want_m = jopt.adamw_update(jg, jo, jp, jc)

    tp = {k: torch.from_numpy(a).to(tdt) for k, a in params.items()}
    tg = {k: torch.from_numpy(a).to(tdt) for k, a in grads.items()}
    to = optimizer.OptState(m={k: torch.from_numpy(a) for k, a in m.items()},
                            v={k: torch.from_numpy(a) for k, a in v.items()},
                            step=3)
    before = copy.deepcopy((tp, to))
    got_p, got_o, got_m = optimizer.adamw_update(tg, to, tp, tc)
    assert got_o.step == int(want_o.step) == 4
    assert_close(float(got_m["lr"]), float(want_m["lr"]), SCHED_RTOL)
    assert_close(float(got_m["grad_norm"]), float(want_m["grad_norm"]),
                 ADAM_RTOL)
    for k in params:
        assert got_p[k].dtype == tdt
        assert got_o.m[k].dtype == got_o.v[k].dtype == torch.float32
        assert_close(_np(got_o.m[k]), np.asarray(want_o.m[k]), ADAM_RTOL)
        assert_close(_np(got_o.v[k]), np.asarray(want_o.v[k]), ADAM_RTOL)
        assert_close(_np(got_p[k]), np.asarray(want_p[k], np.float32),
                     BF16_RTOL if dtype == "bfloat16" else ADAM_RTOL)
    # the inputs are left as they were
    assert all(torch.equal(before[0][k], tp[k]) for k in tp)
    assert all(torch.equal(before[1].m[k], to.m[k]) for k in tp)


def test_init_opt_state_is_float32_beside_each_param():
    cfg = configs.reduced_config(configs.get_config("mamba2-130m")).scaled(
        dtype="bfloat16")
    m = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    opt = optimizer.init_opt_state(m)
    names = [n for n, _ in m.named_parameters()]
    assert list(opt.m) == list(opt.v) == names and opt.step == 0
    for n, p in m.named_parameters():
        assert p.dtype == torch.bfloat16 or n.endswith(
            ("a_log", "dt_bias", "d_skip"))
        assert opt.m[n].dtype == torch.float32 and opt.m[n].shape == p.shape
        assert not opt.m[n].any() and opt.m[n] is not opt.v[n]


# ---------------------------------------------------------------------------
# one step's loss and gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match(arch, objective):
    jm, jstate, st, cfg = _setup(arch, objective)
    b = _stream(objective, cfg, batch=16).batch_for_step(0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (want, _), jg = jax.value_and_grad(
        jtrainer.make_loss_fn(jm, objective, remat=True), has_aux=True)(
            jstate.params, jb)
    want_g = convert.model_params_from_jax(cfg, _jtree(jg))
    loss, _ = trainer.make_loss_fn(st.model, objective)(
        pipeline.put_batch(b, "cpu"))
    params = dict(st.model.named_parameters())
    got_g = trainer._grads(loss, params)
    assert_close(float(loss), float(want), LOSS_RTOL)
    assert sorted(got_g) == sorted(want_g) == sorted(params)
    for k, g in got_g.items():
        assert g.dtype == params[k].dtype and g.shape == params[k].shape
        assert_close(_np(g), _np(want_g[k]), GRAD_RTOL, GRAD_ATOL)
    if objective == "cox" and not cfg.tie_embeddings:
        # the LM head takes no part: a zero gradient, as jax.grad gives
        assert not got_g["lm_head"].any()


def test_cox_eta_gradient_is_w_a_minus_delta():
    """d loss / d eta through autograd is the paper's (w*A - delta) / the
    batch's events, as jax.grad of the reference's loss gives it."""
    from repro.survival import head as jhead
    from repro_torch.core import cox
    from repro_torch.survival import head

    rng = np.random.default_rng(3)
    n = 40
    eta = rng.standard_normal(n).astype(np.float32)
    t = np.round(rng.exponential(size=n), 1).astype(np.float32)  # ties
    d = (rng.uniform(size=n) < 0.6).astype(np.float32)
    want = jax.grad(jhead.cox_partial_likelihood)(
        jnp.asarray(eta), jnp.asarray(t), jnp.asarray(d))
    e = torch.from_numpy(eta).requires_grad_(True)
    loss = head.cox_partial_likelihood(e, torch.from_numpy(t),
                                       torch.from_numpy(d))
    (got,) = torch.autograd.grad(loss, e)
    assert_close(got.numpy(), np.asarray(want), GRAD_RTOL)
    data = cox.prepare(np.zeros((n, 1), np.float32), t, d, device="cpu")
    order = np.argsort(t, kind="stable")
    closed = cox.eta_gradient(data, torch.from_numpy(eta[order]))
    assert_close(got.numpy()[order], closed.numpy() / d.sum(), GRAD_RTOL)


# ---------------------------------------------------------------------------
# steps and trajectories
# ---------------------------------------------------------------------------

def test_microbatch_step_matches_reference():
    jm, jstate, st, cfg = _setup("qwen2.5-3b", vocab=128)
    jc, tc = _tcfg(learning_rate=1e-3, microbatch=4)
    b = _stream("lm", cfg, seed=1).batch_for_step(0)
    js, jmx = jax.jit(jtrainer.make_train_step(jm, jc))(jstate, b)
    st, tm = trainer.make_train_step(st.model, tc)(st, b)
    assert sorted(tm) == sorted(jmx) == ["grad_norm", "loss", "lr"]
    assert_close(float(tm["loss"]), float(jmx["loss"]), LOSS_RTOL)
    assert_close(float(tm["grad_norm"]), float(jmx["grad_norm"]), 1e-5)
    want = convert.model_params_from_jax(cfg, _jtree(js.params))
    lr = float(tm["lr"])
    for k, p in st.model.named_parameters():
        # one Adam step moves each parameter by ~lr g / (|g| + 1e-8): where
        # g is near 1e-8 the fraction of lr follows g's last bits, so each
        # is held within 5 % of the step's lr
        assert_close(_np(p), _np(want[k]), 1e-5, 0.05 * lr)


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-130m"])
def test_trajectory_matches(arch, objective):
    """16 steps from the same weights: the losses step by step."""
    jm, jstate, st, cfg = _setup(arch, objective)
    jc, tc = _tcfg()
    jstep = jax.jit(jtrainer.make_train_step(jm, jc, objective))
    tstep = trainer.make_train_step(st.model, tc, objective)
    stream = _stream(objective, cfg, batch=16)
    want, got = [], []
    js = jstate
    for i in range(16):
        b = stream.batch_for_step(i)
        js, jmx = jstep(js, b)
        st, tm = tstep(st, b)
        want.append(float(jmx["loss"]))
        got.append(float(tm["loss"]))
    assert st.opt.step == int(js.opt.step) == 16
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)


@pytest.mark.parametrize("remat", [True, "nothing", "dots"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-130m"])
def test_remat_changes_memory_not_values(arch, remat):
    cfg = configs.reduced_config(configs.get_config(arch))
    m = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    b = pipeline.put_batch(_stream("lm", cfg).batch_for_step(0), "cpu")
    params = dict(m.named_parameters())
    outs = []
    for r in (False, remat):
        loss, _ = m.loss_lm(b, remat=r)
        outs.append((loss, trainer._grads(loss, params)))
    (l0, g0), (l1, g1) = outs
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_remat_rejects_unknown_policy():
    cfg = configs.reduced_config(configs.get_config("mamba2-130m"))
    m = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    b = pipeline.put_batch(_stream("lm", cfg).batch_for_step(0), "cpu")
    with pytest.raises(ValueError, match="remat"):
        m.loss_lm(b, remat="everything")


def test_bfloat16_step_keeps_dtypes():
    """A bfloat16 backbone's grads are bfloat16, the Cox head stays
    float32, the moments float32; the step keeps every dtype."""
    from repro_torch.survival import deep

    cfg = configs.reduced_config(configs.get_config("mamba2-130m")).scaled(
        dtype="bfloat16")
    st = deep.init_state(Model(cfg, device="cpu"), 0)
    dtypes = {k: p.dtype for k, p in st.model.named_parameters()}
    assert dtypes["cox_head.w"] == torch.float32
    assert dtypes["embed"] == torch.bfloat16
    step = trainer.make_train_step(st.model, configs.TrainConfig(), "cox")
    st, met = step(st, _stream("cox", cfg, batch=16).batch_for_step(0))
    assert np.isfinite(float(met["loss"])) and met["loss"].dtype == \
        torch.float32
    assert {k: p.dtype for k, p in st.model.named_parameters()} == dtypes
    assert all(v.dtype == torch.float32 for v in st.opt.m.values())
    assert st.opt.step == 1


def test_make_loss_fn_rejects_unknown_objective():
    cfg = configs.reduced_config(configs.get_config("mamba2-130m"))
    with pytest.raises(ValueError):
        trainer.make_loss_fn(Model(cfg, device="meta"), "mse")


@pytest.mark.parametrize("arch", OTHER)
def test_unported_families_raise_in_training(arch):
    """A training state is made for every family of the registry (their
    gradients are held in tests/test_torch_families.py); a family the port
    has no code for raises before any state is made."""
    cfg = configs.reduced_config(configs.get_config(arch))
    st = trainer.init_train_state(Model(cfg, device="cpu"),
                                  torch.Generator().manual_seed(0))
    assert sorted(st.opt.m) == sorted(dict(st.model.named_parameters()))
    with pytest.raises(ValueError, match="unknown family 'rnn'"):
        trainer.init_train_state(Model(cfg.scaled(family="rnn"),
                                       device="cpu"),
                                 torch.Generator().manual_seed(0))


def test_init_train_state_draws_from_the_generator():
    cfg = configs.reduced_config(configs.get_config("qwen2.5-3b"))
    a = trainer.init_train_state(Model(cfg, device="cpu"),
                                 torch.Generator().manual_seed(4))
    b = trainer.init_train_state(Model(cfg, device="cpu"),
                                 torch.Generator().manual_seed(4))
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert a.opt.step == 0 and sorted(a.opt.m) == sorted(sa)


def test_run_loop_records_losses_and_calls_on_step():
    jm, jstate, st, cfg = _setup("qwen2.5-3b", vocab=128)
    _, tc = _tcfg()
    seen = []
    st, losses = run_loop(trainer.make_train_step(st.model, tc), st,
                          _stream("lm", cfg), 5, start_step=2, log_every=0,
                          on_step=lambda s, m: seen.append(s))
    assert seen == [2, 3, 4] and len(losses) == 3 and st.opt.step == 3
    assert np.isfinite(losses).all()


def test_run_loop_heartbeats_and_checkpoints(tmp_path):
    from repro_torch.train import checkpoint as ckpt

    _, _, st, cfg = _setup("mamba2-130m", vocab=128)
    _, tc = _tcfg()
    d = str(tmp_path / "ck")
    hb = str(tmp_path / "hb" / "heartbeat.json")
    st, losses = run_loop(trainer.make_train_step(st.model, tc), st,
                          _stream("lm", cfg, seq=16, batch=4), 5,
                          log_every=0, checkpointer=ckpt.AsyncCheckpointer(d),
                          ckpt_every=2, heartbeat_path=hb)
    assert sorted(x for x in __import__("os").listdir(d)) == [
        "step_000000002", "step_000000004", "step_000000005"]
    assert not ft.Heartbeat(hb).is_stale()


# ---------------------------------------------------------------------------
# tests/test_runtime.py and test_arch_smoke.py on the port
# ---------------------------------------------------------------------------

def _tiny(arch="qwen2.5-3b", objective="lm", **kw):
    cfg = configs.reduced_config(configs.get_config(arch)).scaled(
        vocab_size=128)
    m = Model(cfg, device="cpu")
    if objective == "cox":
        from repro_torch.survival import deep
        st = deep.init_state(m, 0)
    else:
        st = trainer.init_train_state(m, torch.Generator().manual_seed(0))
    _, tc = _tcfg(**kw)
    return cfg, st, trainer.make_train_step(m, tc, objective)


def test_train_loop_loss_decreases():
    cfg, state, step_fn = _tiny()
    stream = pipeline.TokenTaskStream(cfg.vocab_size, 32, 8, seed=0)
    losses = []
    for i in range(40):
        state, m = step_fn(state, stream.batch_for_step(i))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_cox_objective_trains():
    cfg, state, step_fn = _tiny(objective="cox")
    stream = pipeline.SurvivalTextStream(cfg.vocab_size, 32, 16, seed=0)
    losses = []
    for i in range(25):
        state, m = step_fn(state, stream.batch_for_step(i))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def test_microbatch_accumulation_matches_full_batch():
    cfg, state, _ = _tiny()
    _, acc_cfg = _tcfg(learning_rate=1e-3, microbatch=4)
    _, full_cfg = _tcfg(learning_rate=1e-3)
    s1 = copy.deepcopy(state)
    s2 = copy.deepcopy(state)
    batch = pipeline.TokenTaskStream(cfg.vocab_size, 32, 8,
                                     seed=1).batch_for_step(0)
    s1, m1 = trainer.make_train_step(s1.model, acc_cfg)(s1, batch)
    s2, m2 = trainer.make_train_step(s2.model, full_cfg)(s2, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)
    for a, b in zip(s1.model.parameters(), s2.model.parameters()):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-3, atol=2e-4)


def test_straggler_monitor():
    mon = ft.StragglerMonitor(factor=3.0)
    flags = [mon.record(1.0) for _ in range(10)]
    assert not any(flags)
    assert mon.record(10.0) is True
    assert mon.n_stragglers == 1
    assert mon.ewma < 1.5


def test_heartbeat(tmp_path):
    hb = ft.Heartbeat(str(tmp_path / "a" / "hb.json"), stale_after_s=60.0)
    assert hb.is_stale()
    hb.beat(3, {"loss": 1.5})
    assert not hb.is_stale()
    assert ft.Heartbeat(hb.path, stale_after_s=-1.0).is_stale()


def test_grad_compression_error_feedback():
    rng = np.random.default_rng(0)
    g = {"a": torch.from_numpy(rng.standard_normal(1000).astype(np.float32)),
         "b": torch.from_numpy(rng.standard_normal((32, 7))
                               .astype(np.float32))}
    res = {k: torch.zeros_like(v) for k, v in g.items()}
    gh, res = compression.compress_decompress(g, res)
    assert float((gh["a"] - g["a"]).abs().max()) < 0.05
    total_true = {k: torch.zeros_like(v) for k, v in g.items()}
    total_hat = {k: torch.zeros_like(v) for k, v in g.items()}
    res = {k: torch.zeros_like(v) for k, v in g.items()}
    for i in range(50):
        gi = {k: v * (1.0 + 0.01 * i) for k, v in g.items()}
        gh, res = compression.compress_decompress(gi, res)
        total_true = {k: total_true[k] + gi[k] for k in g}
        total_hat = {k: total_hat[k] + gh[k] for k in g}
    rel = (float((total_hat["a"] - total_true["a"]).abs().max())
           / float(total_true["a"].abs().max()))
    assert rel < 0.01


def test_compress_decompress_matches_reference():
    """The same int8 round trip and residual, bit for bit, over 3 steps of
    error feedback (float32 and a bfloat16 leaf)."""
    rng = np.random.default_rng(5)
    g = {"a": rng.standard_normal(700).astype(np.float32),
         "b": rng.standard_normal((9, 31)).astype(np.float32) * 3}
    jr = {k: jnp.zeros(v.shape, jnp.float32) for k, v in g.items()}
    tr = {k: torch.zeros(v.shape) for k, v in g.items()}
    for step in range(3):
        jg = {k: jnp.asarray(v * (step + 1)) for k, v in g.items()}
        tg = {k: torch.from_numpy(v * (step + 1)) for k, v in g.items()}
        jh, jr = jcompression.compress_decompress(jg, jr)
        th, tr = compression.compress_decompress(tg, tr)
        for k in g:
            np.testing.assert_array_equal(th[k].numpy(), np.asarray(jh[k]))
            np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]))
    bf = rng.standard_normal(300).astype(np.float32)
    jh, _ = jcompression.compress_decompress(
        {"w": jnp.asarray(bf).astype(jnp.bfloat16)},
        {"w": jnp.zeros(300, jnp.float32)})
    th, _ = compression.compress_decompress(
        {"w": torch.from_numpy(bf).to(torch.bfloat16)},
        {"w": torch.zeros(300)})
    assert th["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(th["w"].float().numpy(),
                                  np.asarray(jh["w"], np.float32))
    assert compression.bytes_saved(tg) == jcompression.bytes_saved(jg)


def test_pipeline_determinism():
    s1 = pipeline.TokenTaskStream(128, 16, 4, seed=42)
    s2 = pipeline.TokenTaskStream(128, 16, 4, seed=42)
    b1, b2 = s1.batch_for_step(7), s2.batch_for_step(7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = s1.batch_for_step(8)
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    ref = jpipeline.TokenTaskStream(128, 16, 4, seed=42).batch_for_step(7)
    np.testing.assert_array_equal(b1["tokens"], ref["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_grads_finite(arch):
    cfg = configs.reduced_config(configs.get_config(arch))
    m = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 25)).astype(np.int32)
    b = pipeline.put_batch({"tokens": toks[:, :-1], "labels": toks[:, 1:]},
                           "cpu")
    loss, _ = m.loss_lm(b)
    grads = trainer._grads(loss, dict(m.named_parameters()))
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads.values())
    assert any(float(g.abs().max()) > 0 for g in grads.values())
