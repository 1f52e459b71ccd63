"""Port's ``moe``, ``hybrid``, ``encdec`` and ``vlm`` backbone families
(``Model.hidden_states``, ``loss_lm`` with the MoE aux loss, ``risk_scores``,
their gradients through ``torch.autograd``, and the converter's
``enc_layers`` and ``shared`` leaves) held against the JAX package at
``reduced_config`` on the same numpy inputs and weights.

Tolerances:
  * float32 within F32_RTOL = 1e-5 of max |ref| in max |port - ref|, as
    tests/test_torch_models.py holds the dense and ssm families (observed
    ~1e-6);
  * a bfloat16 model within BF16_RTOL = 3e-2 in ||port - ref|| / ||ref||
    of the reference's float32 run of the same (bfloat16) weights, as
    tests/test_torch_decode.py holds it and for its reasons (observed
    0.7-2.0e-2);
  * one step's loss within LOSS_RTOL = 1e-6 and every gradient within
    GRAD_RTOL = 2e-5 of its leaf's largest plus GRAD_ATOL = 1e-6, as
    tests/test_torch_train.py holds the dense and ssm families."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.survival.head import init_cox_head as j_init_cox_head  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.survival import deep  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

F32_RTOL = 1e-5
BF16_RTOL = 3e-2
LOSS_RTOL = 1e-6
GRAD_RTOL = 2e-5
GRAD_ATOL = 1e-6
ARCHS = sorted(name for name, cfg in jconfigs.REGISTRY.items()
               if cfg.family in ("moe", "hybrid", "encdec", "vlm"))
DTYPES = ("float32", "bfloat16")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(got, want, rtol, atol=0.0):
    """F32_RTOL and the gradient tolerances in the maximum; BF16_RTOL in
    the norm."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if rtol == BF16_RTOL:
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= rtol, f"||port - ref|| / ||ref|| = {err:.3e}"
        return
    err = np.max(np.abs(got - want)) if got.size else 0.0
    scale = np.max(np.abs(want)) if want.size else 0.0
    assert err <= rtol * scale + atol, \
        f"max |port - ref| {err:.3e}, max |ref| {scale:.3e}"


def _np(t):
    return t.detach().float().numpy()


def _jtree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(name, dtype="float32", seed=0, head=False):
    """(reference model, params, port model holding the same weights,
    config), with a Cox head on both when ``head``. For bfloat16 the
    reference is its float32 model of the same (rounded) weights."""
    jcfg = jconfigs.reduced_config(jconfigs.get_config(name))
    cfg = configs.reduced_config(configs.get_config(name)).scaled(
        dtype=dtype)
    params = jbuild(jcfg.scaled(dtype=dtype)).init_params(
        jax.random.PRNGKey(seed))
    if head:
        params = dict(params, cox_head=j_init_cox_head(
            jax.random.PRNGKey(seed + 1), cfg.d_model))
    m = Model(cfg, device="cpu")
    if head:
        m = deep.init_state(m).model
    m.load_state_dict(convert.model_params_from_jax(cfg, _jtree(params)))
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return jbuild(jcfg), params, m, cfg


def make_batch(cfg, b=3, s=29, seed=1, mrope=False):
    """tokens and labels; an encoder-decoder's source frames; with
    ``mrope``, the stub vision frontend's patch embeddings and (3, B, S)
    positions whose t, h and w rows differ."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.standard_normal(
            (b, s + 3, cfg.d_model)).astype(np.float32)
    if mrope:
        t = np.broadcast_to(np.arange(s), (b, s))
        batch["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
        batch["positions"] = np.stack([t, t // 4, t % 6]).astype(np.int32)
    return batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


CASES = [(name, dtype) for name in ARCHS for dtype in DTYPES]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{n}-{d}" for n, d in CASES])
def case(request):
    name, dtype = request.param
    return (dtype,) + _pair(name, dtype, head=True)


def _rtol(dtype):
    return F32_RTOL if dtype == "float32" else BF16_RTOL


def test_hidden_states_match(case):
    dtype, jm, params, m, cfg = case
    b = make_batch(cfg)
    want, want_aux, _ = jm.hidden_states(params, _jb(b), remat=False)
    with torch.no_grad():
        got, aux = m.hidden_states(_tb(b))
    assert got.dtype == m.dt
    assert_close(_np(got), np.asarray(want), _rtol(dtype))
    if cfg.n_experts:
        assert float(aux) > 0  # summed over the layers
    assert_close(float(aux), float(want_aux), _rtol(dtype))


def test_loss_lm_matches(case):
    """The loss with the MoE aux term, and its parts."""
    dtype, jm, params, m, cfg = case
    b = make_batch(cfg, seed=2)
    want, want_parts = jm.loss_lm(params, _jb(b), remat=False)
    with torch.no_grad():
        got, parts = m.loss_lm(_tb(b))
    for g, w in ((got, want), (parts["ce"], want_parts["ce"]),
                 (parts["aux"], want_parts["aux"])):
        assert_close(float(g), float(w), _rtol(dtype))


def test_risk_scores_match(case):
    dtype, jm, params, m, cfg = case
    b = make_batch(cfg, seed=3)
    want, _ = jm.risk_scores(params, _jb(b), remat=False)
    with torch.no_grad():
        got, _ = m.risk_scores(_tb(b))
    assert got.dtype == torch.float32
    assert_close(_np(got), np.asarray(want), _rtol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_vlm_embeds_and_mrope_positions_match(dtype):
    """qwen2-vl fed its stub frontend's patch embeddings and 3-D M-RoPE
    positions (sections (4, 2, 2) at reduced_config)."""
    jm, params, m, cfg = _pair("qwen2-vl-7b", dtype, seed=4)
    assert cfg.mrope_sections == (4, 2, 2)
    b = make_batch(cfg, seed=5, mrope=True)
    want, _, _ = jm.hidden_states(params, _jb(b), remat=False)
    want_loss, _ = jm.loss_lm(params, _jb(b), remat=False)
    with torch.no_grad():
        got, _ = m.hidden_states(_tb(b))
        got_loss, _ = m.loss_lm(_tb(b))
    assert_close(_np(got), np.asarray(want), _rtol(dtype))
    assert_close(float(got_loss), float(want_loss), _rtol(dtype))
    # the rows differ, so M-RoPE is not the 2-D rotation of positions[0]
    with torch.no_grad():
        flat, _ = m.hidden_states(dict(_tb(b), positions=torch.from_numpy(
            b["positions"][0])))
    assert float((flat - got).abs().max()) > 1e-3


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match(name, remat):
    """One step's LM loss (with the aux term) and every parameter's
    gradient against jax.value_and_grad of the reference's loss_lm."""
    jm, params, m, cfg = _pair(name, seed=6)
    b = make_batch(cfg, seed=7)
    (want, _), jg = jax.value_and_grad(
        lambda p: jm.loss_lm(p, _jb(b), remat=remat), has_aux=True)(params)
    want_g = convert.model_params_from_jax(cfg, _jtree(jg))
    loss, _ = m.loss_lm(_tb(b), remat=remat)
    named = dict(m.named_parameters())
    got_g = trainer._grads(loss, named)
    assert_close(float(loss), float(want), LOSS_RTOL)
    assert sorted(got_g) == sorted(want_g) == sorted(named)
    for k, g in got_g.items():
        assert g.shape == named[k].shape
        assert_close(_np(g), _np(want_g[k]), GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("name", ARCHS)
def test_converter_fills_every_parameter_from_every_leaf(name):
    """Every leaf lands once, the stacked ``layers`` and ``enc_layers``
    one entry per layer, zamba2's ``shared`` block and ``enc_norm`` by
    name; a model loaded from it gives the same bits back."""
    cfg = configs.reduced_config(configs.get_config(name))
    jm = jbuild(jconfigs.reduced_config(jconfigs.get_config(name)))
    params = _jtree(jm.init_params(jax.random.PRNGKey(0)))
    state = convert.model_params_from_jax(cfg, params)
    assert set(state) == set(Model(cfg, device="meta").state_dict())
    stacked = {"layers": cfg.n_layers, "enc_layers": cfg.encoder_layers}
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert sum(stacked.get(path[0].key, 1) for path, _ in leaves) \
        == len(state)
    for path, leaf in leaves:
        keys = [k.key for k in path]
        if keys[0] in stacked:
            for i in range(stacked[keys[0]]):
                np.testing.assert_array_equal(
                    state[".".join([keys[0], str(i)] + keys[1:])].numpy(),
                    leaf[i])
        else:
            np.testing.assert_array_equal(state[".".join(keys)].numpy(),
                                          leaf)
    m = Model(cfg, device="cpu")
    m.load_state_dict(state)
    back = m.state_dict()
    assert all(torch.equal(back[k], state[k]) for k in state)
    if cfg.family == "hybrid":
        assert any(k.startswith("shared.attn.") for k in state)
    if cfg.family == "encdec":
        assert "enc_norm.scale" in state and "layers.0.xattn.wq" in state
    with pytest.raises(ValueError, match="leading axis"):
        top = "enc_layers" if cfg.family == "encdec" else "layers"
        convert.model_params_from_jax(cfg, dict(params, **{
            top: jax.tree.map(lambda a: a[:1], params[top])}))
