"""The port's Nemotron-H family (``family="pattern"``) against the plain
float32 reference ``tests/reference_nemotron_h.py`` on seeded weights at
``reduced_config``'s size, each mixer alone (M with two groups of B and
C, E with a skewed router, * without a rotary embedding) and the whole
pattern's features and risk; the registry and its preset; the spans the
family records; and that mamba2-130m's SSD and Mixtral's ``moe_ffn`` keep
their bits (SHA-256 digests taken before the family was added)."""
import hashlib
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tests")]

import reference_nemotron_h as ref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.models import build_model, moe, ssm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.survival import deep  # noqa: E402

NAME = "nemotron3-nano-30b-a3b"
# float32 against float32: the same sums in other orders
RTOL, ATOL = 2e-4, 2e-5


def _small(**kw):
    return configs.reduced_config(configs.get_config(NAME)).scaled(**kw)


def hf_config(cfg) -> dict:
    """The reference's configuration (the published config.json's keys)
    of a ``PatternConfig``."""
    return {
        "num_hidden_layers": cfg.n_layers, "hidden_size": cfg.d_model,
        "vocab_size": cfg.vocab_size, "dtype": cfg.dtype,
        "hybrid_override_pattern": cfg.layer_pattern,
        "layer_norm_epsilon": cfg.rms_eps,
        "mamba_num_heads": cfg.ssm_heads, "mamba_head_dim": cfg.ssm_head_dim,
        "n_groups": cfg.ssm_groups, "ssm_state_size": cfg.ssm_state,
        "chunk_size": cfg.ssm_chunk, "conv_kernel": 4,
        "n_routed_experts": cfg.n_experts,
        "num_experts_per_tok": cfg.n_experts_per_tok,
        "moe_intermediate_size": cfg.d_ff,
        "moe_shared_expert_intermediate_size": cfg.shared_d_ff,
        "routed_scaling_factor": cfg.routed_scaling,
        "norm_topk_prob": cfg.norm_topk_prob,
        "n_group": cfg.router_groups, "topk_group": cfg.router_topk_groups,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim}


def _model(cfg, seed=0):
    """The port's model with every weight drawn, the norms, biases and the
    SSM's terms moved off their constants (so a path that drops one
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
    assert (len(pat), pat.count("M"), pat.count("E"), pat.count("*")) \
        == (52, 23, 23, 6)
    assert (cfg.d_model, cfg.vocab_size, cfg.rms_eps, cfg.dtype) \
        == (2688, 131072, 1e-5, "bfloat16")
    assert (cfg.ssm_heads * cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state,
            cfg.ssm_chunk) == (4096, 8, 128, 128)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (32, 2, 128)
    assert (cfg.n_experts, cfg.n_experts_per_tok, cfg.d_ff, cfg.shared_d_ff,
            cfg.routed_scaling, cfg.norm_topk_prob, cfg.router_groups,
            cfg.router_topk_groups) == (128, 6, 1856, 3712, 2.5, True, 1, 1)
    small = configs.reduced_config(cfg)
    assert (small.layer_pattern, small.n_experts, small.n_experts_per_tok,
            small.ssm_groups) == ("MEM*E", 8, 2, 2)
    assert small.ssm_heads * small.ssm_head_dim != \
        small.ssm_expand * small.d_model
    with pytest.raises(ValueError, match="layer_pattern"):
        cfg.scaled(n_layers=4)
    with pytest.raises(ValueError, match="group-limited"):
        cfg.scaled(router_groups=8, router_topk_groups=4)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("nemotron-9")


def test_whole_model_on_the_meta_device_has_the_published_count():
    m = build_model(configs.get_config(NAME), device="meta")
    n = sum(p.numel() for p in m.parameters())
    assert n == 31_577_940_288      # 63.2 GB in bfloat16
    experts = sum(p.numel() for k, p in m.named_parameters()
                  if ".moe.w_" in k)
    assert experts == 23 * 128 * 2 * 2688 * 1856


def test_cache_paths_raise():
    m = build_model(_small(), device="cpu")
    for call in (lambda: m.init_cache(1, 8), lambda: m.init_cache_specs(1, 8),
                 lambda: m.prefill({"tokens": _tokens(m.cfg)}),
                 lambda: m.decode_step(None, _tokens(m.cfg, 2, 1))):
        with pytest.raises(NotImplementedError, match="decode cache"):
            call()


# -- each mixer alone ---------------------------------------------------------

def test_mamba_mixer_with_two_groups():
    cfg = _small()
    m = _model(cfg)
    p = m.layers[0]["mamba"]
    h = _x((2, 40, cfg.d_model), 2)
    got = ssm.mamba2_forward(p, h, d_state=cfg.ssm_state,
                             head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk,
                             n_heads=cfg.ssm_heads, n_groups=cfg.ssm_groups,
                             eps=cfg.rms_eps)
    w = _weights(m)
    want = torch.stack([ref._mamba(w, "layers.0.", row, hf_config(cfg),
                                   torch.matmul) for row in h])
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_heads_read_their_own_group():
    """Head h reads B and C of group h // (H / G): changing group 1's B
    moves heads 3-5 of 6 and leaves heads 0-2; all groups in one pass
    give each group's heads scanned alone (a partial chunk included)."""
    b, s, h, hd, g, n = 2, 27, 6, 4, 2, 8
    xh = _x((b, s, h, hd), 3)
    dt = torch.nn.functional.softplus(_x((b, s, h), 4))
    a = -torch.linspace(1.0, 4.0, h)
    no_skip = torch.zeros(h)
    bb, cc = _x((b, s, g * n), 5), _x((b, s, g * n), 6)
    y, _ = kref.ssd_scan_ref(xh, dt, a, bb, cc, no_skip, 8, g)
    bb2 = bb.clone()
    bb2[..., n:] += 1.0
    y2, _ = kref.ssd_scan_ref(xh, dt, a, bb2, cc, no_skip, 8, g)
    assert torch.equal(y[:, :, :3], y2[:, :, :3])
    assert not torch.allclose(y[:, :, 3:], y2[:, :, 3:])
    ref_y = ref._ssd(xh[0], dt[0], a, bb[0].reshape(s, g, n),
                     cc[0].reshape(s, g, n))
    torch.testing.assert_close(y[0], ref_y, rtol=RTOL, atol=ATOL)
    # the groups in one pass against each group's heads as a scan alone
    heads = [slice(3 * i, 3 * i + 3) for i in range(g)]
    ys, sts = zip(*(kref.ssd_scan_ref(xh[:, :, hs], dt[..., hs], a[hs],
                                      bb[..., n * i:n * i + n],
                                      cc[..., n * i:n * i + n],
                                      no_skip[hs], 8, 1)
                    for i, hs in enumerate(heads)))
    _, st = kref.ssd_scan_ref(xh, dt, a, bb, cc, no_skip, 8, g)
    torch.testing.assert_close(y, torch.cat(ys, 2), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(st, torch.cat(sts, 1), rtol=1e-6, atol=1e-6)


def test_gated_norm_per_group_with_the_config_epsilon():
    d, gr = 12, 3
    params = {"norm_scale": 1.0 + _x((d,), 7), "w_out": torch.eye(d)}
    y, z = _x((2, 5, d), 8), _x((2, 5, d), 9)
    got = ssm._gated_out(params, y, z, torch.float32, gr, 1e-5)
    want = ref._rms(y * torch.nn.functional.silu(z), params["norm_scale"],
                    1e-5, gr)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # one group of all channels, and the epsilon read: a tiny input tells
    tiny = 1e-3 * y
    one = ssm._gated_out(params, tiny, z, torch.float32)
    assert not torch.allclose(one, ssm._gated_out(params, tiny, z,
                                                  torch.float32, 1, 1e-5))
    torch.testing.assert_close(one, ref._rms(
        tiny * torch.nn.functional.silu(z), params["norm_scale"], 1e-6),
        rtol=1e-6, atol=1e-6)


def test_moe_mixer_drops_no_token_under_a_skewed_router():
    """A router bias that sends every token to expert 0: the pairs are
    all computed (no capacity), and the bias changes the choice, not the
    weights."""
    cfg = _small()
    m = _model(cfg)
    p = dict(m.layers[1]["moe"].items())
    h = _x((2, 40, cfg.d_model), 10)
    k = cfg.n_experts_per_tok
    _, plain = moe.route_sigmoid(p, h, k, cfg.routed_scaling)
    skew = torch.zeros(cfg.n_experts)
    skew[0] = 10.0
    p["router_bias"] = skew
    topv, topi = moe.route_sigmoid(p, h, k, cfg.routed_scaling)
    load = moe.expert_load(topi, cfg.n_experts)
    assert int(load[0]) == 80 and int(load.sum()) == 80 * k
    assert not torch.equal(topi, plain)
    scores = torch.sigmoid(h.reshape(-1, cfg.d_model) @ p["router"])
    chosen = scores.gather(1, topi)
    torch.testing.assert_close(
        topv, cfg.routed_scaling * chosen / chosen.sum(-1, keepdim=True))
    got = moe.sparse_moe(p, h, k, cfg.routed_scaling)
    w = {f"layers.1.moe.{n}": t.detach() for n, t in p.items()}.__getitem__
    xt = h.reshape(-1, cfg.d_model)
    want, choice, gap = ref._experts(w, "layers.1.", xt, hf_config(cfg),
                                     torch.matmul)
    torch.testing.assert_close(got, want.reshape(h.shape), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(choice, topi) and gap == 0.0
    # the unskewed choices, replayed, stand below the reference's own
    _, _, gap = ref._experts(w, "layers.1.", xt, hf_config(cfg),
                             torch.matmul, plain)
    assert gap > 0.1
    # every pair of the sorted dispatch against one expert a token at a time
    each = torch.stack([
        sum(topv[t, j] * torch.relu(xt[t] @ p["w_up"][topi[t, j]]) ** 2
            @ p["w_down"][topi[t, j]] for j in range(k))
        for t in range(xt.shape[0])])
    torch.testing.assert_close(
        moe.sorted_experts(xt, topv, topi, load, p["w_up"], p["w_down"]),
        each, rtol=RTOL, atol=ATOL)


def test_attention_mixer_is_gqa_without_rotary_embedding():
    cfg = _small()
    m = _model(cfg)
    p = m.layers[3]["attn"]
    h = _x((2, 40, cfg.d_model), 11)
    got = tf.attention_mixer(p, cfg, h)
    want = torch.stack([ref._attention(_weights(m), "layers.3.", row,
                                       hf_config(cfg), torch.matmul)
                        for row in h])
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    # no position: the last query reads the earlier keys as a set
    perm = torch.cat([torch.randperm(39, generator=torch.Generator()
                                     .manual_seed(0)), torch.tensor([39])])
    moved = tf.attention_mixer(p, cfg, h[:, perm])
    torch.testing.assert_close(moved[:, -1], got[:, -1], rtol=RTOL,
                               atol=ATOL)


# -- the whole pattern --------------------------------------------------------

def test_whole_pattern_features_and_risk():
    cfg = _small()
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


def test_whole_pattern_in_bfloat16_near_the_float32_reference():
    """The bfloat16 model against the reference's float32 run of the same
    (rounded) weights at the model's own expert choices, held in the norm
    within the zoo's BF16_RTOL (3e-2); those choices stand within a
    rounding of the reference's (its own would flip 2-6 of 80 tokens a
    layer here, which reads ~0.11)."""
    cfg = _small(dtype="bfloat16")
    m = _model(cfg)
    toks = _tokens(cfg)
    routes = []
    _, feats = _recording(routes, lambda: deep.make_featurizer(m)(
        {"tokens": toks.numpy()}))
    f_ref, _, _, gap = ref.features(_weights(m), toks, hf_config(cfg),
                                    routes=routes)
    err = torch.linalg.norm(feats - f_ref) / torch.linalg.norm(f_ref)
    assert err < 3e-2, err
    assert 0.0 < gap < 0.05, gap


def test_spans_of_the_pattern_family(tmp_path):
    cfg = _small()
    m = _model(cfg)
    path = tmp_path / "spans.jsonl"
    trace.configure(str(path))
    try:
        deep.make_featurizer(m)({"tokens": _tokens(cfg).numpy()})
    finally:
        trace.configure(None)
    spans = [json.loads(line) for line in path.read_text().splitlines()]
    names = [s["name"] for s in spans]
    for name, count in (("moe.route", 2), ("moe.experts", 2),
                        ("moe.shared", 2), ("attn.mix", 1), ("ssm.in", 2),
                        ("ssm.scan", 2), ("ssm.out", 2),
                        ("featurize.batch", 1)):
        assert names.count(name) == count, name
    for s in spans:
        if s["name"] == "moe.route":
            attrs = s["attrs"]
            assert attrs["tokens"] == 80
            assert isinstance(attrs["max_load"], int)
            assert 80 * 2 / 8 <= attrs["max_load"] <= 80


# -- bits of the families that share the code ---------------------------------

def _fill(params, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name in sorted(params):
            p = params[name]
            draw = torch.randn(p.shape, generator=gen) \
                * getattr(p, "init_scale", 0.1)
            base = getattr(p, "init_value", None)
            p.copy_(draw if base is None else base + draw)


def _sha(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()[:32]


@pytest.mark.parametrize("dtype,digest", [
    ("float32", "0f6c09bbd06af927c141cdcb81c0380c"),
    ("bfloat16", "a788da6e93ab385ee87a9a4a317ea744")])
def test_mamba2_130m_ssd_keeps_its_bits(dtype, digest):
    """mamba2-130m's mixer at its published widths (one group, eps 1e-6):
    a 160-token forward (a partial chunk) with its state, then a decode
    step, as before the grouped path was added."""
    dt = getattr(torch, dtype)
    cfg = configs.get_config("mamba2-130m")
    p = ssm.init_mamba2(cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim,
                        cfg.ssm_expand, dtype=dt, device="cpu")
    _fill(p, 3)
    kw = dict(d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
              expand=cfg.ssm_expand)
    x = _x((2, 160, cfg.d_model), 4).to(dt)
    y, st = ssm.mamba2_forward(p, x, chunk=cfg.ssm_chunk, return_state=True,
                               eps=cfg.rms_eps, **kw)
    y1, st1 = ssm.mamba2_decode_step(p, _x((2, 1, cfg.d_model), 5).to(dt),
                                     st, eps=cfg.rms_eps, **kw)
    assert _sha(y, st.conv, st.ssm, y1, st1.conv, st1.ssm) == digest


@pytest.mark.parametrize("groups,dtype,digest", [
    (1, "float32", "7f94f078237bfdea1431103f0022bea1"),
    (1, "bfloat16", "d8d829a65a8d7736cb87dcaa7371eb3d"),
    (2, "float32", "2267d9f75e20f2252a4e25ebe1af87fa"),
    (2, "bfloat16", "97cb52843dbf52da8ab93ae8a8a98097")])
def test_plain_ssd_keeps_its_bits(groups, dtype, digest):
    """The plain SSD's y, final state and the gradients of every input, S =
    37 padding the last chunk of 16: the bits of the one-group form and of
    the grouped form from before the two were merged into
    ``ref.ssd_scan_ref``."""
    dt_ = getattr(torch, dtype)
    b, s, h, hd, n = 2, 37, 4, 16, 16
    xh = _x((b, s, h, hd), 10).to(dt_).requires_grad_()
    dt_raw = _x((b, s, h), 11).requires_grad_()
    a_log = _x((h,), 12).requires_grad_()
    bb = _x((b, s, groups * n), 13).to(dt_).requires_grad_()
    cc = _x((b, s, groups * n), 14).to(dt_).requires_grad_()
    d_skip = _x((h,), 15).requires_grad_()
    y, st = kref.ssd_scan_ref(xh, torch.nn.functional.softplus(dt_raw),
                              -torch.exp(a_log), bb, cc, d_skip, 16, groups)
    loss = (y.float() * _x(y.shape, 16)).sum() \
        + (st * _x(st.shape, 17)).sum()
    grads = torch.autograd.grad(loss, (xh, dt_raw, a_log, bb, cc, d_skip))
    assert _sha(y, st, *grads) == digest


@pytest.mark.parametrize("dtype,capacity,digest", [
    ("float32", 1.25, "a44fe52d249b4c905985c6227a9aabb5"),
    ("float32", 0.25, "61af78567902eef8fe39f6558fbe1cb8"),
    ("bfloat16", 1.25, "b1a23e5ae8105671233fefe046afab1a"),
    ("bfloat16", 0.25, "def40181da73d7f7a4ad2e7ea0351c83")])
def test_mixtral_moe_ffn_keeps_its_bits(dtype, capacity, digest):
    """Mixtral's softmax top-2 with a capacity (0.25 drops most pairs) and
    its aux loss, as before the sigmoid router was added."""
    dt = getattr(torch, dtype)
    p = moe.init_moe(128, 256, 8, dtype=dt, device="cpu")
    _fill(p, 6)
    out, aux = moe.moe_ffn(p, _x((3, 40, 128), 7).to(dt), 2,
                           capacity_factor=capacity)
    assert _sha(out, aux) == digest


# -- the benchmark's cell at a CPU's size -------------------------------------

def _tiny_cell(seed=2 ** 31 + 29):
    from perfbench import harness

    c = harness.cell("nemotron3-nano-featurize-4k", seed, device="cpu")
    c.config.update(hf_config(_small()))
    c.traffic.update(batch=2, seq=32, checked=2)
    return c


def test_featurize_cell_on_the_cpu():
    """The cell's driver at a tiny size: the program's outputs pass the
    cell's limits against the reference, and the control (the reference
    with float8 projections and experts) does not."""
    from perfbench import harness

    c = _tiny_cell()
    drv = harness.driver(c.traffic["driver"])
    st = drv.setup(c)
    win = drv.window(st, 1.0)
    assert win["units"] >= 2
    out = drv.outputs(st)
    drv.release(st)
    checks = drv.check(st, out, drv.reference(st, program=out))
    assert all(ch.ok for ch in checks), checks
    ctrl = drv.reference(st, dtype="float8", program=out)
    checks = drv.check(st, ctrl, drv.reference(st, program=ctrl))
    assert not all(ch.ok for ch in checks), checks
