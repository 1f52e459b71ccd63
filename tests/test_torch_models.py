"""Port's configs/, models/ (layers, transformer, ssm, model), convert's
model_params_from_jax, data/pipeline.py and train/fault_tolerance's
DataSkipper, held against the JAX package on the same numpy inputs and the
same weights (the reference's params carried across by the converter).

Tolerances: float32 outputs within F32_RTOL = 1e-5 of the reference,
measured as max |port - ref| <= F32_RTOL * max |ref| (the two libraries
round matmuls, exps and pows in different orders; observed ~1e-6 through
whole reduced models). Each family's bfloat16 case within BF16_RTOL = 3e-2
the same way: bfloat16 keeps 8 bits, a half-ulp is 2^-9 ~ 2e-3, and the
reference's compiler fuses elementwise bfloat16 chains in float32 where the
port rounds after each op (observed 4e-3 dense, 1.2e-2 ssm, 2-4 layers).
mamba2-130m also runs at its full widths, cut to 2 layers, in both dtypes.
Streams and configs equal exactly."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.survival import deep as jdeep  # noqa: E402
from repro.survival.head import init_cox_head as j_init_cox_head  # noqa: E402
from repro.train import fault_tolerance as jft  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import build_model, layers, ssm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.survival import deep  # noqa: E402
from repro_torch.train.fault_tolerance import DataSkipper  # noqa: E402

F32_RTOL = 1e-5
BF16_RTOL = 3e-2
ALL_ARCHS = sorted(jconfigs.REGISTRY)
ARCHS = sorted(name for name, cfg in jconfigs.REGISTRY.items()
               if cfg.family in ("dense", "ssm"))
OTHER = sorted(name for name in ALL_ARCHS if name not in ARCHS)


def assert_close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= rtol, f"max |port - ref| / max |ref| = {err:.3e}"


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _pair(name, dtype="float32", seed=0):
    """(reference model, its params, port model holding the same weights,
    config) at reduced_config."""
    jcfg = jconfigs.reduced_config(jconfigs.get_config(name)).scaled(
        dtype=dtype)
    cfg = configs.reduced_config(configs.get_config(name)).scaled(dtype=dtype)
    jm = jbuild(jcfg)
    params = jm.init_params(jax.random.PRNGKey(seed))
    m = Model(cfg, device="cpu")
    m.load_state_dict(convert.model_params_from_jax(
        cfg, jax.tree.map(np.asarray, params)))
    return jm, params, m, cfg


def _tokens(cfg, b=3, s=37, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ALL_ARCHS)
def test_config_matches_reference(name):
    ref = jconfigs.get_config(name)
    got = configs.get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.vocab_padded == ref.vocab_padded
    assert dataclasses.asdict(configs.reduced_config(got)) \
        == dataclasses.asdict(jconfigs.reduced_config(ref))
    assert [(s.name, r) for s, r in configs.applicable_shapes(got)] \
        == [(s.name, r) for s, r in jconfigs.applicable_shapes(ref)]


def test_registry_shapes_and_train_config_match():
    assert sorted(configs.REGISTRY) == ALL_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert dataclasses.asdict(configs.TrainConfig()) \
        == dataclasses.asdict(jconfigs.TrainConfig())
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches(dtype):
    x = _rand((3, 5, 64), 0, 3.0)
    scale = _rand((64,), 1)
    jx = jnp.asarray(x).astype(dtype)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale).astype(dtype)}, jx)
    got = layers.rmsnorm({"scale": _t(scale).to(getattr(torch, dtype))},
                         _t(x).to(getattr(torch, dtype)))
    assert str(got.dtype) == f"torch.{dtype}"
    assert_close(_np(got), np.asarray(want, np.float32),
                 F32_RTOL if dtype == "float32" else BF16_RTOL)


@pytest.mark.parametrize("theta,offset", [(1e4, 0), (1e6, 0), (1e4, 1000)])
def test_apply_rope_matches(theta, offset):
    x = _rand((2, 9, 3, 16), 2)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32)[None] + offset,
                          (2, 9)).copy()
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.apply_rope(_t(x), _t(pos), theta)
    assert_close(_np(got), want, F32_RTOL)
    assert_close(_np(layers.rope_freqs(16, theta)),
                 jlayers.rope_freqs(16, theta), F32_RTOL)


def test_apply_rope_rejects_3d_positions():
    with pytest.raises(NotImplementedError, match="A8b"):
        layers.apply_rope(torch.zeros(1, 4, 2, 8),
                          torch.zeros(3, 1, 4, dtype=torch.int32))


FLASH_CASES = {
    # name: (sq, skv, h, kh, q_chunk, kv_chunk, causal, window, kv_len)
    "causal_gqa_ragged": (37, 37, 4, 2, 16, 16, True, -1, None),
    "window": (37, 37, 4, 2, 16, 8, True, 5, None),
    "mha_chunk_longer_than_seq": (12, 12, 4, 4, 32, 32, True, -1, None),
    "noncausal_kv_len": (20, 29, 6, 2, 8, 16, False, -1, (29, 11)),
    "causal_kv_len": (30, 30, 4, 1, 4, 16, True, -1, (30, 17)),
    "window_gqa_kv_len": (40, 40, 8, 2, 16, 8, True, 7, (23, 40)),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches(case):
    sq, skv, h, kh, qc, kc, causal, window, kv_len = FLASH_CASES[case]
    q = _rand((2, sq, h, 16), 3)
    k = _rand((2, skv, kh, 16), 4)
    v = _rand((2, skv, kh, 16), 5)
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)
    want = jlayers.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_chunk=qc, kv_chunk=kc,
        kv_len=None if kl is None else jnp.asarray(kl))
    got = layers.flash_attention(
        _t(q), _t(k), _t(v), causal=causal, window=window, q_chunk=qc,
        kv_chunk=kc, kv_len=None if kl is None else _t(kl))
    assert_close(_np(got), want, F32_RTOL)


def test_flash_attention_gqa_reads_kv_head_h_over_g():
    """Query head h attends with KV head h // G: repeating each KV head G
    times and running plain multi-head attention gives the same output."""
    q, k, v = _t(_rand((1, 11, 6, 8), 6)), _t(_rand((1, 11, 2, 8), 7)), \
        _t(_rand((1, 11, 2, 8), 8))
    gqa = layers.flash_attention(q, k, v, q_chunk=4, kv_chunk=4)
    mha = layers.flash_attention(q, k.repeat_interleave(3, dim=2),
                                 v.repeat_interleave(3, dim=2), q_chunk=4,
                                 kv_chunk=4)
    assert_close(_np(gqa), _np(mha), F32_RTOL)


def test_qkv_project_and_mlp_match():
    gen = torch.Generator().manual_seed(0)
    attn = layers.init_attention(32, 4, 2, 8, True, torch.float32, "cpu")
    mlp = layers.init_mlp(32, 48, torch.float32, "cpu")
    with torch.no_grad():
        for p in attn.values():
            p.normal_(generator=gen)
        for p in mlp.values():
            p.normal_(std=p.init_scale, generator=gen)
    jattn = {k: jnp.asarray(_np(v)) for k, v in attn.items()}
    jmlp = {k: jnp.asarray(_np(v)) for k, v in mlp.items()}
    x = _rand((2, 7, 32), 9)
    with torch.no_grad():
        got = layers.qkv_project(attn, _t(x), 4, 2, 8)
        got_mlp = layers.mlp(mlp, _t(x))
    for g, w in zip(got, jlayers.qkv_project(jattn, jnp.asarray(x), 4, 2, 8)):
        assert_close(_np(g), w, F32_RTOL)
    assert_close(_np(got_mlp), jlayers.mlp(jmlp, jnp.asarray(x)), F32_RTOL)


# ---------------------------------------------------------------------------
# ssm
# ---------------------------------------------------------------------------

def _mamba_params(d_model=32, d_state=8, head_dim=8, seed=0):
    jp = jssm.init_mamba2(jax.random.PRNGKey(seed), d_model, d_state,
                          head_dim, dtype=jnp.float32)
    # non-trivial decay, skip and bias terms
    rng = np.random.default_rng(seed)
    jp = dict(jp, dt_bias=jnp.asarray(rng.normal(size=jp["dt_bias"].shape),
                                      jnp.float32),
              conv_b=jnp.asarray(rng.normal(size=jp["conv_b"].shape) * 0.1,
                                 jnp.float32),
              norm_scale=jnp.asarray(1 + 0.1 * rng.normal(
                  size=jp["norm_scale"].shape), jnp.float32))
    return jp, {k: _t(np.asarray(v)) for k, v in jp.items()}


@pytest.mark.parametrize("seq,chunk", [(37, 16), (5, 16), (32, 16),
                                       (48, 128)])
def test_mamba2_forward_matches(seq, chunk):
    jp, tp = _mamba_params()
    x = _rand((2, seq, 32), 10)
    want = jssm.mamba2_forward(jp, jnp.asarray(x), d_state=8, head_dim=8,
                               chunk=chunk)
    got = ssm.mamba2_forward(tp, _t(x), d_state=8, head_dim=8, chunk=chunk)
    assert_close(_np(got), want, F32_RTOL)


def test_causal_conv_matches():
    x, w, b = _rand((2, 13, 24), 11), _rand((4, 24), 12), _rand((24,), 13)
    want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = ssm._causal_conv(_t(x), _t(w), _t(b))
    assert_close(_np(got), want, F32_RTOL)


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,n_layers", [
    ("gemma3-12b", 2), ("gemma3-12b", 12), ("mixtral-8x7b", 4),
    ("qwen2.5-3b", 3)])
def test_attention_pattern_matches(name, n_layers):
    for cfg_of in (lambda m: m.get_config(name),
                   lambda m: m.reduced_config(m.get_config(name))):
        jw, jth = jtf.attention_pattern(cfg_of(jconfigs), n_layers)
        w, th = tf.attention_pattern(cfg_of(configs), n_layers)
        np.testing.assert_array_equal(w, np.asarray(jw))
        np.testing.assert_array_equal(th, np.asarray(jth))


@pytest.mark.parametrize("name,layer", [("gemma3-12b", 0), ("gemma3-12b", 1),
                                        ("qwen2.5-3b", 0)])
def test_block_forward_matches(name, layer):
    """One block with its layer's window and theta (gemma3's layer 0 is
    local with window 8, layer 1 global at theta 1e6)."""
    jm, params, m, cfg = _pair(name)
    windows, thetas = tf.attention_pattern(cfg, cfg.n_layers)
    jw, jth = jtf.attention_pattern(jm.cfg, cfg.n_layers)
    x = _rand((2, 21, cfg.d_model), 14)
    pos = np.broadcast_to(np.arange(21, dtype=np.int32), (2, 21)).copy()
    jp = jax.tree.map(lambda a: a[layer], params["layers"])
    want, _, _ = jtf.block_forward(jp, jm.cfg, jnp.asarray(x),
                                   jnp.asarray(pos), jw[layer], jth[layer])
    with torch.no_grad():
        got, aux = tf.block_forward(m.layers[layer], cfg, _t(x), _t(pos),
                                    int(windows[layer]),
                                    float(thetas[layer]))
    assert float(aux) == 0.0
    assert_close(_np(got), want, F32_RTOL)


# ---------------------------------------------------------------------------
# the model, every dense and ssm arch at reduced_config
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def test_hidden_states_match(pair):
    jm, params, m, cfg = pair
    b = _tokens(cfg)
    want, _, _ = jm.hidden_states(params, _jbatch(b), remat=False)
    with torch.no_grad():
        got, aux = m.hidden_states(pipeline.put_batch(b, "cpu"))
    assert float(aux) == 0.0
    assert_close(_np(got), want, F32_RTOL)


def test_risk_scores_match(pair):
    jm, params, m, cfg = pair
    jparams = dict(params, cox_head=j_init_cox_head(jax.random.PRNGKey(5),
                                                    cfg.d_model))
    m2 = deep.init_state(Model(cfg, device="cpu")).model
    m2.load_state_dict(convert.model_params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams)))
    b = _tokens(cfg, seed=3)
    want, _ = jm.risk_scores(jparams, _jbatch(b), remat=False)
    with torch.no_grad():
        got, _ = m2.risk_scores(pipeline.put_batch(b, "cpu"))
    assert got.dtype == torch.float32
    assert_close(_np(got), want, F32_RTOL)


def test_loss_lm_matches(pair):
    jm, params, m, cfg = pair
    b = _tokens(cfg, seed=4)
    want, want_parts = jm.loss_lm(params, _jbatch(b), remat=False)
    with torch.no_grad():
        got, parts = m.loss_lm(pipeline.put_batch(b, "cpu"))
    assert_close(float(got), float(want), F32_RTOL)
    assert_close(float(parts["ce"]), float(want_parts["ce"]), F32_RTOL)


@pytest.mark.parametrize("name", ["qwen2.5-3b", "mamba2-130m"],
                         ids=["dense", "ssm"])
def test_bfloat16_forward_matches(name):
    jm, params, m, cfg = _pair(name, dtype="bfloat16", seed=2)
    assert m.embed.dtype == torch.bfloat16
    b = _tokens(cfg, b=4, s=29, seed=6)
    want, _, _ = jm.hidden_states(params, _jbatch(b), remat=False)
    with torch.no_grad():
        got, _ = m.hidden_states(pipeline.put_batch(b, "cpu"))
    assert got.dtype == torch.bfloat16
    assert_close(_np(got), np.asarray(want, np.float32), BF16_RTOL)


@pytest.mark.parametrize("dtype,rtol", [("float32", F32_RTOL),
                                         ("bfloat16", BF16_RTOL)])
def test_mamba2_full_width_matches(dtype, rtol):
    """The deep-survival backbone at its published widths (d_model 768,
    ssm_state 128, 24 heads of 64, chunk 128, vocab 2,048), cut to 2
    layers, on a seq of 48 that pads to one chunk: hidden states and the
    pooled risk against the reference."""
    dcfg = deep.DeepSurvivalConfig(full=True)
    cfg = deep.model_config(dcfg).scaled(n_layers=2, dtype=dtype)
    jcfg = jdeep.model_config(jdeep.DeepSurvivalConfig(full=True)).scaled(
        n_layers=2, dtype=dtype)
    assert (cfg.d_model, cfg.ssm_state, cfg.ssm_chunk) == (768, 128, 128)
    jm = jbuild(jcfg)
    params = jm.init_params(jax.random.PRNGKey(7))
    params = dict(params, cox_head=j_init_cox_head(jax.random.PRNGKey(8),
                                                   cfg.d_model))
    m = deep.init_state(Model(cfg, device="cpu")).model
    m.load_state_dict(convert.model_params_from_jax(
        cfg, jax.tree.map(np.asarray, params)))
    b = _tokens(cfg, b=2, s=dcfg.seq, seed=9)
    want, _, _ = jm.hidden_states(params, _jbatch(b), remat=False)
    want_risk, _ = jm.risk_scores(params, _jbatch(b), remat=False)
    with torch.no_grad():
        got, _ = m.hidden_states(pipeline.put_batch(b, "cpu"))
        got_risk, _ = m.risk_scores(pipeline.put_batch(b, "cpu"))
    assert_close(_np(got), np.asarray(want, np.float32), rtol)
    assert_close(_np(got_risk), np.asarray(want_risk, np.float32), rtol)


def test_gemma_scales_embeddings():
    _, _, m, cfg = _pair("gemma3-12b")
    b = pipeline.put_batch(_tokens(cfg), "cpu")
    with torch.no_grad():
        x = m._embed_in(b)
    assert_close(_np(x), _np(m.embed[b["tokens"].long()])
                 * cfg.d_model ** 0.5, F32_RTOL)


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_converter_fills_every_parameter_from_every_leaf(name):
    cfg = configs.reduced_config(configs.get_config(name))
    jm = jbuild(jconfigs.reduced_config(jconfigs.get_config(name)))
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    state = convert.model_params_from_jax(cfg, params)
    model_keys = set(Model(cfg, device="meta").state_dict())
    assert set(state) == model_keys
    # every leaf accounted for: stacked leaves give one entry per layer
    leaves = jax.tree_util.tree_leaves_with_path(params)
    n_entries = sum(cfg.n_layers if path[0].key == "layers" else 1
                    for path, _ in leaves)
    assert n_entries == len(state)
    for path, leaf in leaves:
        keys = [k.key for k in path]
        if keys[0] == "layers":
            for i in (0, cfg.n_layers - 1):
                np.testing.assert_array_equal(
                    state[".".join(["layers", str(i)] + keys[1:])].numpy(),
                    leaf[i])
        else:
            np.testing.assert_array_equal(state[".".join(keys)].numpy(),
                                          leaf)


def test_converter_raises_on_unused_missing_or_misshapen_leaves():
    name = "qwen2.5-3b"
    cfg = configs.reduced_config(configs.get_config(name))
    jm = jbuild(jconfigs.reduced_config(jconfigs.get_config(name)))
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="unused: .*'extra'"):
        convert.model_params_from_jax(cfg, dict(params, extra=np.zeros(3)))
    layers_ = dict(params["layers"], attn=dict(params["layers"]["attn"]))
    del layers_["attn"]["bq"]
    with pytest.raises(ValueError, match="unfilled: .*layers.0.attn.bq"):
        convert.model_params_from_jax(cfg, dict(params, layers=layers_))
    with pytest.raises(ValueError, match="embed"):
        convert.model_params_from_jax(cfg, dict(
            params, embed=params["embed"][:, :-1]))
    with pytest.raises(ValueError, match="leading axis"):
        convert.model_params_from_jax(cfg, dict(params, layers=jax.tree.map(
            lambda a: a[:1], params["layers"])))


def test_converter_carries_bfloat16_exactly():
    name = "mamba2-130m"
    cfg = configs.reduced_config(configs.get_config(name)).scaled(
        dtype="bfloat16")
    jm = jbuild(jconfigs.reduced_config(jconfigs.get_config(name)).scaled(
        dtype="bfloat16"))
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(1)))
    state = convert.model_params_from_jax(cfg, params)
    assert state["embed"].dtype == torch.bfloat16
    assert state["layers.0.mamba.a_log"].dtype == torch.float32
    np.testing.assert_array_equal(state["embed"].float().numpy(),
                                  params["embed"].astype(np.float32))


# ---------------------------------------------------------------------------
# what is not ported yet, and the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", OTHER)
def test_unported_families_raise(name):
    cfg = configs.reduced_config(configs.get_config(name))
    with pytest.raises(NotImplementedError, match="A8b"):
        build_model(cfg, device="cpu")


def test_prefill_and_decode_raise():
    m = Model(configs.reduced_config(configs.get_config("qwen2.5-3b")),
              device="meta")
    for fn in (m.prefill, m.decode_step):
        with pytest.raises(NotImplementedError, match="A8b"):
            fn({})


def test_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(configs.reduced_config(configs.get_config("qwen2.5-3b")))


def test_model_init_is_seeded():
    cfg = configs.reduced_config(configs.get_config("mamba2-130m"))
    a = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    b = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    c = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed"], sc["embed"])
    assert float(sa["embed"].std()) == pytest.approx(0.02, rel=0.1)
    assert torch.equal(sa["layers.1.mamba.d_skip"],
                       torch.ones_like(sa["layers.1.mamba.d_skip"]))


def test_reset_parameters_is_the_only_draw():
    """Without a generator the build draws nothing; reset_parameters then
    draws every weight and restores every constant, whatever the module
    held before."""
    cfg = configs.reduced_config(configs.get_config("qwen2.5-3b"))
    drawn = []
    real = torch.randn
    try:
        torch.randn = lambda *a, **k: drawn.append(a) or real(*a, **k)
        m = build_model(cfg, device="cpu")
    finally:
        torch.randn = real
    assert not drawn
    with torch.no_grad():
        for p in m.parameters():
            p.fill_(7.0)
    m.reset_parameters(torch.Generator().manual_seed(3))
    fresh = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    got, want = m.state_dict(), fresh.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert torch.equal(got["layers.0.attn.bq"],
                       torch.zeros_like(got["layers.0.attn.bq"]))
    assert torch.equal(got["final_norm.scale"],
                       torch.ones_like(got["final_norm.scale"]))


# ---------------------------------------------------------------------------
# data pipeline and DataSkipper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", range(6))
def test_streams_match_reference(step):
    for cls, jcls, kw in (
            (pipeline.SurvivalTextStream, jpipeline.SurvivalTextStream,
             dict(vocab=512, seq_len=20, batch=16, seed=3)),
            (pipeline.TokenTaskStream, jpipeline.TokenTaskStream,
             dict(vocab=300, seq_len=17, batch=5, seed=2))):
        got = cls(**kw).batch_for_step(step)
        want = jcls(**kw).batch_for_step(step)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_data_skipper_matches_reference():
    for seed in (0, 77, 2**31 - 2):
        assert [DataSkipper(seed).seed_for_step(s) for s in range(0, 50, 7)] \
            == [jft.DataSkipper(seed).seed_for_step(s)
                for s in range(0, 50, 7)]


def test_put_batch_keeps_dtypes():
    b = pipeline.SurvivalTextStream(64, 8, 4).batch_for_step(0)
    t = pipeline.put_batch(b, "cpu")
    assert t["tokens"].dtype == torch.int32
    assert t["time"].dtype == torch.float32
    np.testing.assert_array_equal(t["tokens"].numpy(), b["tokens"])
