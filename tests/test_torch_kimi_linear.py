"""The port's Kimi Linear layers in the pattern family against the plain
float32 reference ``tests/reference_kimi_linear.py`` on seeded weights at
``reduced_config``'s size ("K-KELE"): the chunked KDA scan against the
token recurrence (ragged chunks, sub-chunk boundaries, strong decays), the
KDA and MLA mixers, the gated experts and a held share of them, the share
test (two halves make the whole layer), the whole model through
``make_featurizer``, its spans; the registry's pattern against the
published ``kda_layers`` and ``full_attn_layers``; and that Nemotron-H's
expert layer and model keep their bits (SHA-256 digests taken before the
gated and held paths were added)."""
import hashlib
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tests")]

import reference_kimi_linear as ref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.models import build_model, kda, moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.survival import deep  # noqa: E402

NAME = "kimi-linear-48b-a3b"
# float32 against float32: the same sums in other orders (the chunked
# scan's triangular solve against the token recurrence among them)
RTOL, ATOL = 2e-4, 2e-5
# the published config.json's linear_attn_config, 1-based
KDA_LAYERS = [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22,
              23, 25, 26]
FULL_ATTN_LAYERS = [4, 8, 12, 16, 20, 24, 27]


def _small(**kw):
    return configs.reduced_config(configs.get_config(NAME)).scaled(**kw)


def hf_config(cfg) -> dict:
    """The reference's configuration (the published config.json's keys, and
    the held share) of a Kimi ``PatternConfig``."""
    mixers = cfg.layer_pattern[::2]
    held = cfg.experts_here
    return {
        "num_hidden_layers": len(mixers), "hidden_size": cfg.d_model,
        "vocab_size": cfg.vocab_size, "dtype": cfg.dtype,
        "rms_norm_eps": cfg.rms_eps,
        "first_k_dense_replace": cfg.layer_pattern[1::2].count("-"),
        "linear_attn_config": {
            "kda_layers": [i + 1 for i, c in enumerate(mixers) if c == "K"],
            "full_attn_layers": [i + 1 for i, c in enumerate(mixers)
                                 if c == "L"],
            "num_heads": cfg.kda_heads, "head_dim": cfg.kda_head_dim,
            "short_conv_kernel_size": cfg.kda_conv},
        "num_attention_heads": cfg.n_heads,
        "kv_lora_rank": cfg.kv_lora_rank,
        "qk_nope_head_dim": cfg.qk_nope_head_dim,
        "qk_rope_head_dim": cfg.qk_rope_head_dim,
        "v_head_dim": cfg.v_head_dim, "intermediate_size": cfg.dense_d_ff,
        "moe_intermediate_size": cfg.d_ff,
        "num_experts": len(held), "num_experts_published": cfg.n_experts,
        "experts_held": [held.start, held.stop],
        "num_experts_per_token": cfg.n_experts_per_tok,
        "moe_renormalize": cfg.norm_topk_prob,
        "routed_scaling_factor": cfg.routed_scaling,
        "num_shared_experts": 1}


def _model(cfg, seed=0):
    """The port's model with every weight drawn, the norms, biases and
    decay terms moved off their constants (so a path that drops one
    shows), and a Cox head."""
    gen = torch.Generator().manual_seed(seed)
    m = build_model(cfg, device="cpu", generator=gen)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if not hasattr(p, "init_scale"):
                p.add_((0.1 * torch.randn(p.shape, generator=gen)).to(p.dtype))
    deep.init_state(m, seed)
    with torch.no_grad():
        m.cox_head["w"].mul_(5.0)
    return m.eval()


def _weights(m):
    sd = {k: v.detach() for k, v in m.named_parameters()}
    return lambda name: sd[name]


def _tokens(cfg, b=2, s=40, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (b, s), generator=g)


def _x(shape, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


# -- configuration ------------------------------------------------------------

def test_config_and_registry():
    cfg = configs.get_config(NAME)
    assert NAME in configs.PORT_REGISTRY and NAME not in configs.REGISTRY
    assert isinstance(cfg, configs.PatternConfig) and cfg.family == "pattern"
    pat = cfg.layer_pattern
    assert (len(pat), pat.count("K"), pat.count("L"), pat.count("-"),
            pat.count("E")) == (54, 20, 7, 1, 26)
    for i in range(1, 28):
        mixer, ffn = pat[2 * i - 2], pat[2 * i - 1]
        assert mixer == ("K" if i in KDA_LAYERS else "L"), i
        assert (mixer == "L") == (i in FULL_ATTN_LAYERS), i
        assert ffn == ("-" if i == 1 else "E"), i
    assert ref.pattern({**hf_config(cfg), "linear_attn_config": {
        "kda_layers": KDA_LAYERS, "full_attn_layers": FULL_ATTN_LAYERS},
        "first_k_dense_replace": 1, "num_hidden_layers": 27}) == pat
    assert (cfg.d_model, cfg.vocab_size, cfg.rms_eps, cfg.dtype) \
        == (2304, 163840, 1e-5, "bfloat16")
    assert (cfg.kda_heads, cfg.kda_head_dim, cfg.kda_conv, cfg.kda_chunk) \
        == (32, 128, 4, 64)
    assert (cfg.n_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim,
            cfg.qk_rope_head_dim, cfg.v_head_dim) == (32, 512, 128, 64, 128)
    assert (cfg.n_experts, cfg.n_experts_per_tok, cfg.d_ff, cfg.shared_d_ff,
            cfg.dense_d_ff, cfg.routed_scaling, cfg.gated_experts) \
        == (256, 8, 1024, 1024, 9216, 2.446, True)
    assert cfg.experts_held == range(0, 128) and cfg.experts_here.start == 0
    # Nemotron-H: the new fields at their defaults, every expert here
    nem = configs.get_config("nemotron3-nano-30b-a3b")
    assert (nem.gated_experts, nem.experts_held, nem.experts_here,
            nem.kda_heads, nem.kv_lora_rank, nem.dense_d_ff) \
        == (False, None, range(128), 0, 0, 0)
    small = configs.reduced_config(cfg)
    assert (small.layer_pattern, small.n_experts, small.experts_held,
            small.qk_nope_head_dim + small.qk_rope_head_dim,
            small.v_head_dim) == ("K-KELE", 8, None, 24, 16)
    for bad in (range(0, 0), range(0, 257), range(0, 128, 2)):
        with pytest.raises(ValueError, match="experts_held"):
            cfg.scaled(experts_held=bad)
    with pytest.raises(ValueError, match="layer_pattern"):
        cfg.scaled(layer_pattern="K-Q" + pat[3:])


def test_whole_model_on_the_meta_device_holds_the_cards_share():
    m = build_model(configs.get_config(NAME), device="meta")
    n = sum(p.numel() for p in m.parameters())
    assert n == 25_567_470_464      # 51.1 GB in bfloat16
    experts = sum(p.numel() for k, p in m.named_parameters()
                  if ".moe.w_" in k)
    assert experts == 26 * 128 * 3 * 2304 * 1024
    assert m.layers[3]["moe"]["router"].shape == (2304, 256)
    assert m.layers[3]["moe"]["w_gate"].shape == (128, 2304, 1024)


# -- the chunked KDA scan -----------------------------------------------------

def _recurrence(q, k, v, g, beta):
    """The delta rule token by token in float64: (o, final state)."""
    b, s, h, dk = q.shape
    q, k, v, g, beta = (t.double() for t in (q, k, v, g, beta))
    st = torch.zeros(b, h, dk, v.shape[-1], dtype=torch.float64)
    o = []
    for t in range(s):
        st = st * torch.exp(g[:, t])[..., None]
        err = v[:, t] - torch.einsum("bhk,bhkv->bhv", k[:, t], st)
        st = st + torch.einsum("bhk,bhv->bhkv", k[:, t],
                               beta[:, t, :, None] * err)
        o.append(torch.einsum("bhk,bhkv->bhv", q[:, t] * dk ** -0.5, st))
    return torch.stack(o, 1), st


def _scan_inputs(s, strength, seed):
    b, h, dk, dv = 2, 3, 8, 6
    unit = lambda t: torch.nn.functional.normalize(t, dim=-1)  # noqa: E731
    return (unit(_x((b, s, h, dk), seed)), unit(_x((b, s, h, dk), seed + 1)),
            _x((b, s, h, dv), seed + 2),
            -strength * torch.rand((b, s, h, dk), generator=torch.Generator()
                                   .manual_seed(seed + 3)),
            torch.rand((b, s, h), generator=torch.Generator()
                       .manual_seed(seed + 4)))


@pytest.mark.parametrize("s,chunk,strength", [
    (37, 16, 1.0),      # a ragged last chunk; one sub-chunk a chunk
    (64, 64, 1.0),      # one whole chunk of four sub-chunks
    (100, 32, 20.0),    # g down to -20 a step: a chunk's decay underflows
    (70, 64, 20.0),     # ragged, strong, four sub-chunks
    (130, 48, 5.0),     # chunk 48: sub-chunks of 16
])
def test_chunked_kda_against_the_token_recurrence(s, chunk, strength):
    """float32 chunks against the float64 token recurrence: the WY solve
    and the chunk's products round at ~1e-7 relative and are carried
    through the state; read 2.4e-6 at most here."""
    q, k, v, g, beta = _scan_inputs(s, strength, 20)
    o, st = kref.kda_scan_ref(q, k, v, g, beta, chunk)
    want_o, want_st = _recurrence(q, k, v, g, beta)
    assert torch.isfinite(o).all() and torch.isfinite(st).all()
    assert o.dtype == st.dtype == torch.float32
    torch.testing.assert_close(o.double(), want_o, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(st.double(), want_st, rtol=1e-5, atol=1e-5)


def test_chunk_groups_do_not_change_the_scan(monkeypatch):
    """The scan over one group of chunks and over groups of one chunk
    gives the same numbers (each chunk's parts do not depend on the
    group)."""
    q, k, v, g, beta = _scan_inputs(150, 3.0, 30)
    whole = kref.kda_scan_ref(q, k, v, g, beta, 16)
    monkeypatch.setattr(kref, "KDA_GROUP_BYTES", 1)
    one = kref.kda_scan_ref(q, k, v, g, beta, 16)
    for a, b in zip(whole, one):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_kda_mixer():
    cfg = _small()
    m = _model(cfg)
    h = _x((2, 40, cfg.d_model), 2)
    got = kda.kda_forward(m.layers[0]["kda"], h, n_heads=cfg.kda_heads,
                          head_dim=cfg.kda_head_dim, chunk=cfg.kda_chunk,
                          eps=cfg.rms_eps)
    want = ref._kda(_weights(m), "layers.0.", h, hf_config(cfg), torch.matmul)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    # the decay reaches the output: another A_log, another result
    p = dict(m.layers[0]["kda"].items())
    p["a_log"] = p["a_log"] + 1.0
    moved = kda.kda_forward(p, h, n_heads=cfg.kda_heads,
                            head_dim=cfg.kda_head_dim, chunk=cfg.kda_chunk)
    assert not torch.allclose(moved, got, rtol=1e-3, atol=1e-4)


# -- latent attention ---------------------------------------------------------

def test_mla_mixer_is_explicit_softmax_without_rotary_embedding():
    cfg = _small()
    m = _model(cfg)
    p = m.layers[4]["mla"]
    h = _x((2, 40, cfg.d_model), 11)
    got = tf.mla_mixer(p, cfg, h)
    want = torch.stack([ref._mla(_weights(m), "layers.4.", row,
                                 hf_config(cfg), torch.matmul) for row in h])
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    # no position: the last query reads the earlier keys as a set
    perm = torch.cat([torch.randperm(39, generator=torch.Generator()
                                     .manual_seed(0)), torch.tensor([39])])
    moved = tf.mla_mixer(p, cfg, h[:, perm])
    torch.testing.assert_close(moved[:, -1], got[:, -1], rtol=RTOL,
                               atol=ATOL)


# -- gated experts and a held share -------------------------------------------

def _moe_weights(p, prefix="layers.3."):
    return {f"{prefix}moe.{n}": t.detach() for n, t in p.items()}.__getitem__


def test_gated_sparse_moe_against_per_expert_loops():
    cfg = _small()
    m = _model(cfg)
    p = dict(m.layers[3]["moe"].items())
    h = _x((2, 40, cfg.d_model), 12)
    k = cfg.n_experts_per_tok
    got = moe.sparse_moe(p, h, k, cfg.routed_scaling)
    xt = h.reshape(-1, cfg.d_model)
    want, _, gap = ref._experts(_moe_weights(p), "layers.3.", xt,
                                hf_config(cfg), torch.matmul)
    torch.testing.assert_close(got, want.reshape(h.shape), rtol=RTOL,
                               atol=ATOL)
    assert gap == 0.0
    # every pair against its SwiGLU expert, one token at a time
    topv, topi = moe.route_sigmoid(p, h, k, cfg.routed_scaling)
    silu = torch.nn.functional.silu
    each = torch.stack([
        sum(topv[t, j] * (silu(xt[t] @ p["w_gate"][e]) * (xt[t] @ p["w_up"][e]))
            @ p["w_down"][e] for j, e in enumerate(topi[t].tolist()))
        for t in range(xt.shape[0])])
    load = moe.expert_load(topi, cfg.n_experts)
    torch.testing.assert_close(
        moe.sorted_experts(xt, topv, topi, load, p["w_up"], p["w_down"],
                           p["w_gate"]), each, rtol=RTOL, atol=ATOL)


def _halves(p, n):
    """The layer's parameters as two cards hold them: experts [0, n/2) and
    [n/2, n), the router, its bias and the shared expert on both."""
    split = ("w_gate", "w_up", "w_down")
    return [{k: (v[sl] if k in split else v) for k, v in p.items()}
            for sl in (slice(0, n // 2), slice(n // 2, n))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_two_halves_make_the_uncut_layer(dtype):
    """The share test: at a small size, what the two cards' shares give,
    with the shared expert (which both compute alike) counted once, adds
    up to the uncut layer. float32: the same sums in other orders;
    bfloat16: each half's output and the whole rounded once to bfloat16,
    2^-8 of the largest output, and the shared expert's rounding met
    twice."""
    cfg = _small(dtype=dtype)
    m = _model(cfg)
    p = dict(m.layers[3]["moe"].items())
    h = _x((2, 40, cfg.d_model), 13).to(m.dt)
    k, e = cfg.n_experts_per_tok, cfg.n_experts
    whole = moe.sparse_moe(p, h, k, cfg.routed_scaling).float()
    a, b = (moe.sparse_moe(q, h, k, cfg.routed_scaling, first=f).float()
            for q, f in zip(_halves(p, e), (0, e // 2)))
    xt = h.reshape(-1, cfg.d_model)
    shared = moe._mlp(xt, p["shared_up"], p["shared_down"],
                      p["shared_gate"]).float().reshape(h.shape)
    tol = dict(rtol=RTOL, atol=ATOL) if dtype == "float32" else \
        dict(rtol=0.0, atol=3 * 2 ** -8 * float(whole.detach().abs().max()))
    torch.testing.assert_close(a + b - shared, whole, **tol)
    # each half alone is not the whole, and both hold some pairs
    assert not torch.allclose(a, whole, atol=1e-3)
    assert not torch.allclose(b, whole, atol=1e-3)


def test_a_held_share_computes_only_its_pairs(monkeypatch, tmp_path):
    """Experts 4-7 of 8 held: the grouped GEMMs see only the pairs of held
    experts, which the ``held_pairs`` attribute counts, and the result is
    the reference's for the same share."""
    cfg = _small()
    m = _model(cfg)
    p = _halves(dict(m.layers[3]["moe"].items()), cfg.n_experts)[1]
    h = _x((2, 40, cfg.d_model), 14)
    k = cfg.n_experts_per_tok
    rows = []
    real = torch.nn.functional.grouped_mm

    def spy(a, b, **kw):
        rows.append(a.shape[0])
        return real(a, b, **kw)

    monkeypatch.setattr(torch.nn.functional, "grouped_mm", spy)
    path = tmp_path / "spans.jsonl"
    trace.configure(str(path))
    try:
        got = moe.sparse_moe(p, h, k, cfg.routed_scaling, first=4)
    finally:
        trace.configure(None)
    _, topi = moe.route_sigmoid(p, h, k, cfg.routed_scaling)
    held = int((topi >= 4).sum())
    assert 0 < held < topi.numel() and rows == [held] * 3
    route = [json.loads(line) for line in path.read_text().splitlines()
             if json.loads(line)["name"] == "moe.route"]
    assert route[0]["attrs"]["held_pairs"] == held
    hf = {**hf_config(cfg), "experts_held": [4, 8]}
    want, _, _ = ref._experts(_moe_weights(p), "layers.3.",
                              h.reshape(-1, cfg.d_model), hf, torch.matmul)
    torch.testing.assert_close(got, want.reshape(h.shape), rtol=RTOL,
                               atol=ATOL)
    # a router bias that sends every token to experts 0-3: no pair held
    # here, the shared expert alone
    skew = torch.zeros(cfg.n_experts)
    skew[:4] = 10.0
    rows.clear()
    alone = moe.sparse_moe({**p, "router_bias": skew}, h, k,
                           cfg.routed_scaling, first=4)
    shared = moe._mlp(h.reshape(-1, cfg.d_model), p["shared_up"],
                      p["shared_down"], p["shared_gate"])
    assert rows == []
    torch.testing.assert_close(alone, shared.reshape(h.shape))


def test_the_held_count_is_read_once_behind_the_shared_expert(monkeypatch,
                                                              tmp_path):
    """The held path starts the held pairs' count on its way to the host
    in ``moe.route``, runs the shared expert, and waits for the count once,
    in ``moe.experts``; the result has the bits of the count read inside
    ``held_experts``."""
    cfg = _small()
    m = _model(cfg)
    p = _halves(dict(m.layers[3]["moe"].items()), cfg.n_experts)[1]
    h = _x((2, 40, cfg.d_model), 15)
    k = cfg.n_experts_per_tok
    log = []
    real_read, real_mlp = moe._read_later, moe._mlp

    def read_later(t):
        log.append("start")
        wait = real_read(t)

        def logged():
            log.append("wait")
            return wait()
        return logged

    def mlp(x, up, *rest):
        log.append("shared" if up is p["shared_up"] else "experts")
        return real_mlp(x, up, *rest)

    monkeypatch.setattr(moe, "_read_later", read_later)
    monkeypatch.setattr(moe, "_mlp", mlp)
    path = tmp_path / "spans.jsonl"
    trace.configure(str(path))
    try:
        got = moe.sparse_moe(p, h, k, cfg.routed_scaling, first=4)
    finally:
        trace.configure(None)
    monkeypatch.undo()
    assert log == ["start", "shared", "wait", "experts"]
    names = [json.loads(line)["name"]
             for line in path.read_text().splitlines()]
    assert names == ["moe.route", "moe.shared", "moe.experts"]
    xt = h.reshape(-1, cfg.d_model)
    topv, topi = moe.route_sigmoid(p, h, k, cfg.routed_scaling)
    load = moe.expert_load(topi, cfg.n_experts)[4:]
    routed = moe.held_experts(xt, topv, topi - 4, load, p["w_up"],
                              p["w_down"], p["w_gate"])
    shared = moe._mlp(xt, p["shared_up"], p["shared_down"], p["shared_gate"])
    want = (routed + shared.float()).to(h.dtype).reshape(h.shape)
    assert torch.equal(got, want)


# -- the whole model ----------------------------------------------------------

def _recording(routes, fn):
    """``fn()`` with each expert layer's choices appended to ``routes``."""
    real = moe.route_sigmoid

    def recording(*args, **kwargs):
        topv, topi = real(*args, **kwargs)
        routes.append(topi)
        return topv, topi

    moe.route_sigmoid = recording
    try:
        return fn()
    finally:
        moe.route_sigmoid = real


@pytest.mark.parametrize("held", [None, range(0, 4), range(4, 8)])
def test_whole_model_features_and_risk(held):
    """Every expert held, and each half as one card holds it."""
    cfg = _small(experts_held=held)
    m = _model(cfg)
    toks = _tokens(cfg)
    routes = []
    risk, feats = _recording(routes, lambda: deep.make_featurizer(m)(
        {"tokens": toks.numpy()}))
    f_ref, r_ref, chosen, gap = ref.features(_weights(m), toks,
                                             hf_config(cfg))
    torch.testing.assert_close(feats, f_ref, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(risk, r_ref, rtol=RTOL, atol=ATOL)
    assert gap == 0.0 and len(chosen) == 2
    assert all(torch.equal(a, b) for a, b in zip(routes, chosen))


def test_whole_model_in_bfloat16_near_the_float32_reference():
    """The bfloat16 model, one card's share, against the reference's
    float32 run of the same (rounded) weights at the model's own expert
    choices, held in the norm within the zoo's BF16_RTOL (3e-2); those
    choices stand within a rounding of the reference's."""
    cfg = _small(dtype="bfloat16", experts_held=range(0, 4))
    m = _model(cfg)
    toks = _tokens(cfg)
    routes = []
    _, feats = _recording(routes, lambda: deep.make_featurizer(m)(
        {"tokens": toks.numpy()}))
    f_ref, _, _, gap = ref.features(_weights(m), toks, hf_config(cfg),
                                    routes=routes)
    err = torch.linalg.norm(feats - f_ref) / torch.linalg.norm(f_ref)
    assert err < 3e-2, err
    assert 0.0 <= gap < 0.05, gap


def test_spans_of_the_kimi_layers(tmp_path):
    cfg = _small(experts_held=range(0, 4))
    m = _model(cfg)
    path = tmp_path / "spans.jsonl"
    trace.configure(str(path))
    try:
        deep.make_featurizer(m)({"tokens": _tokens(cfg).numpy()})
    finally:
        trace.configure(None)
    spans = [json.loads(line) for line in path.read_text().splitlines()]
    names = [s["name"] for s in spans]
    for name, count in (("kda.in", 2), ("kda.scan", 2), ("kda.out", 2),
                        ("mla.mix", 1), ("moe.route", 2), ("moe.experts", 2),
                        ("moe.shared", 2), ("featurize.batch", 1)):
        assert names.count(name) == count, name
    for s in spans:
        if s["name"] in ("kda.scan", "mla.mix"):
            assert s["attrs"]["path"] == "eager"
        if s["name"] == "moe.route":
            attrs = s["attrs"]
            assert attrs["tokens"] == 80
            assert isinstance(attrs["held_pairs"], int)
            assert 0 <= attrs["held_pairs"] <= 80 * 2
            assert 80 * 2 / 8 <= attrs["max_load"] <= 80


# -- Nemotron-H keeps its bits ------------------------------------------------

def _sha(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()[:32]


@pytest.mark.parametrize("dtype,moe_digest,model_digest", [
    ("float32", "e58b944dc284fd2841757e74a86a1e8a",
     "6f91f7a4525388bcaa5b9f5e989df4b9"),
    ("bfloat16", "20522bb67e6aedcd8165a1beb15a8edc",
     "d15190412b49d5fde085ab06142ab10d")])
def test_nemotron_keeps_its_bits(dtype, moe_digest, model_digest):
    """Nemotron-H's relu^2 expert layer (every expert held) and its whole
    reduced model's hidden states, as before the gated experts and the
    held share were added."""
    cfg = configs.reduced_config(configs.get_config(
        "nemotron3-nano-30b-a3b")).scaled(dtype=dtype)
    m = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        bias = m.layers[1]["moe"]["router_bias"]
        bias.copy_(0.05 * _x(bias.shape, 6))
        h = _x((2, 40, cfg.d_model), 7).to(m.dt)
        y = moe.sparse_moe(m.layers[1]["moe"], h, cfg.n_experts_per_tok,
                           cfg.routed_scaling, cfg.norm_topk_prob)
        toks = torch.randint(0, cfg.vocab_size, (2, 40),
                             generator=torch.Generator().manual_seed(8))
        hid, _ = m.hidden_states({"tokens": toks})
    assert (_sha(y), _sha(hid)) == (moe_digest, model_digest)
