"""The Kimi Linear cell's pieces on the CPU at a small size: the benchmark's
reference against the repo's tests' copy, the weights drawn by (seed,
name) alike into the program and for the reference, the configuration
file read into the registry's configuration, the forward's operations a
token by hand, and the cell's driver, whose checks pass the program and
catch the float8 control and two planted faults."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tests")]

from perfbench import harness  # noqa: E402
from perfbench.data import kimi_weights, survival_text  # noqa: E402
from perfbench.reference import kimi_linear  # noqa: E402

BIG = 2 ** 31 + 4243
CELL = "kimi-linear-featurize-8k"
# the configuration file at a small size: layers K- KE LE, experts 0-3 of
# 8 held
SMALL = {
    "num_hidden_layers": 3, "first_k_dense_replace": 1,
    "linear_attn_config": {"kda_layers": [1, 2], "full_attn_layers": [3],
                           "num_heads": 4, "head_dim": 16,
                           "short_conv_kernel_size": 4},
    "hidden_size": 64, "vocab_size": 300, "num_attention_heads": 4,
    "num_key_value_heads": 4, "head_dim": 16, "kv_lora_rank": 32,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
    "intermediate_size": 256, "moe_intermediate_size": 128,
    "num_experts": 4, "num_experts_published": 8, "experts_held": [0, 4],
    "num_experts_per_token": 2, "kda_chunk": 16, "dtype": "float32"}


def _config(**kw):
    cfg = harness.load_json(harness.HERE / "configs"
                            / "kimi-linear-48b-a3b.json")
    cfg.update(SMALL, **kw)
    return cfg


def test_reference_against_the_tests_copy():
    import reference_kimi_linear as tests_ref

    cfg = _config()
    toks = torch.as_tensor(survival_text.batch(BIG, 0, 3, 40, 300))
    draw = lambda name: kimi_weights.draw(cfg, BIG, name, "cpu")  # noqa
    got = kimi_linear.features(draw, toks, cfg)
    want = tests_ref.features(draw, toks, cfg)
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))
    fp8 = kimi_linear.features(draw, toks, cfg, matmul=kimi_linear.fp8_matmul)
    assert not torch.allclose(fp8[0], got[0], rtol=1e-3, atol=1e-4)
    # replayed at the float8 run's choices: both copies report one gap
    again = [kimi_linear.features(draw, toks, cfg, routes=fp8[2]),
             tests_ref.features(draw, toks, cfg, routes=fp8[2])]
    assert again[0][3] == again[1][3] > 0.0
    torch.testing.assert_close(again[0][0], again[1][0], rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_drawn_alike_for_the_program_and_the_reference(dtype):
    from repro_torch.models import build_model

    from perfbench.drivers import featurize_kimi

    cfg = _config(dtype=dtype)
    model = build_model(featurize_kimi.model_config(cfg), device="cpu")
    head = kimi_weights.fill(model, cfg, BIG)
    params = dict(model.named_parameters())
    assert set(params) == set(kimi_weights.spec(cfg))
    for name, p in params.items():
        assert torch.equal(p.detach(), kimi_weights.draw(cfg, BIG, name,
                                                         "cpu")), name
    assert torch.equal(head["cox_head.w"], params["cox_head.w"].detach())
    moe = "layers.3.moe."
    assert params[moe + "router"].shape == (64, 8)
    assert params[moe + "w_gate"].shape == (4, 64, 128)
    for name in ("router", "router_bias"):
        assert params[moe + name].dtype == torch.float32
    a_log = params["layers.0.kda.a_log"].detach()
    assert a_log.dtype == torch.float32 and a_log.shape == (4,)
    assert bool(((a_log >= 0) & (a_log <= torch.log(torch.tensor(16.)))).all())
    dt = torch.nn.functional.softplus(params["layers.0.kda.dt_bias"].detach())
    assert dt.shape == (64,) and bool(((dt > 9e-5) & (dt < 0.11)).all())
    assert params[moe + "w_up"].dtype == getattr(torch, dtype)
    # another seed or another name, another tensor
    other = kimi_weights.draw(cfg, BIG + 1, moe + "w_up", "cpu")
    assert not torch.equal(other, params[moe + "w_up"].detach())
    assert not torch.equal(params["layers.0.ln.scale"],
                           params["layers.2.ln.scale"])


def test_the_file_is_the_registrys_configuration():
    """The configuration file read by the driver gives the program's
    registry entry (54 sublayers, experts 0-127 of 256), and it changes
    only ``num_experts`` from the published keys."""
    from repro_torch.configs import get_config

    from perfbench.drivers import featurize_kimi

    cfg = harness.load_json(harness.HERE / "configs"
                            / "kimi-linear-48b-a3b.json")
    assert cfg["reduced"] == ["num_experts"]
    assert (cfg["num_experts"], cfg["num_experts_published"],
            cfg["experts_held"]) == (128, 256, [0, 128])
    assert "2 H100s" in cfg["deployment"]
    got = featurize_kimi.model_config(cfg)
    assert got == get_config("kimi-linear-48b-a3b")
    for key, bad in (("hidden_act", "gelu"), ("mla_use_nope", False),
                     ("q_lora_rank", 1536), ("num_experts", 100)):
        with pytest.raises(ValueError):
            featurize_kimi.model_config({**cfg, key: bad})


def test_forward_flops_by_hand():
    d, h, hk, s = 64, 4, 16, 32
    kda = (2 * d * (3 * h * hk + 2 * hk + h)   # input projection: 29,184
           + 2 * 4 * 3 * h * hk                 # conv: 1,536
           + 2 * 2 * hk * h * hk                # F_b, G_b: 4,096
           + 7 * h * hk * hk                    # delta rule: 7,168
           + 2 * h * hk * d                     # output projection: 8,192
           + 4 * d)
    mla = (2 * d * 4 * 24                       # q: 12,288
           + 2 * d * (32 + 8)                   # compressed KV: 5,120
           + 2 * 32 * 4 * 32                    # decompression: 8,192
           + 4 * (24 + 16) * (s + 1)            # causal scores and values
           + 2 * 4 * 16 * d                     # output projection
           + 4 * d)
    dense = 6 * d * 256 + 4 * d
    moe = (2 * d * 8                            # router over all 8
           + 2 * 4 / 8 * 6 * d * 128            # half of 2 SwiGLU experts
           + 6 * d * 128                        # the shared expert
           + 4 * d)
    assert (kda, mla, dense, moe) == (50_432, 39_328, 98_560, 99_584)
    want = 2 * kda + mla + dense + 2 * moe + 5 * d
    got = harness.roofline("kimi_linear_forward").flops_per_token(
        _config(), s)
    assert got == want == 438_240


def test_the_full_size_forward_is_about_four_point_six_gflop_a_token():
    cfg = harness.load_json(harness.HERE / "configs"
                            / "kimi-linear-48b-a3b.json")
    got = harness.roofline("kimi_linear_forward").flops_per_token(cfg, 8192)
    assert 4.6e9 < got < 4.7e9


# -- the cell's driver at a CPU's size ----------------------------------------

def _tiny_cell(seed=2 ** 31 + 31):
    c = harness.cell(CELL, seed, device="cpu")
    c.config.update(SMALL)
    c.traffic.update(batch=2, seq=40, checked=2)
    return c


def _checks(control=False):
    c = _tiny_cell()
    drv = harness.driver(c.traffic["driver"])
    st = drv.setup(c)
    win = drv.window(st, 0.5)
    assert win["units"] >= 1
    out = drv.outputs(st)
    drv.release(st)
    if control:
        out = drv.reference(st, dtype="float8", program=out)
    return drv.check(st, out, drv.reference(st, program=out))


def test_featurize_cell_on_the_cpu():
    """The program's outputs pass the cell's limits against the reference,
    and the control (the reference with float8 projections and experts)
    does not."""
    checks = _checks()
    assert all(ch.ok for ch in checks), checks
    checks = _checks(control=True)
    assert not all(ch.ok for ch in checks), checks


def _decay_after_update(q, k, v, g, beta, chunk):
    """The delta rule with each step's decay applied after its update:
    S_t = Diag(exp g_t) ((I - beta k k^T) S_{t-1} + beta k v^T)."""
    b, s, h, d = q.shape
    q, k, v, g, beta = (t.float() for t in (q, k, v, g, beta))
    st = torch.zeros(b, h, d, v.shape[-1])
    o = []
    for t in range(s):
        kt = k[:, t, :, None, :]
        st = st + kt.transpose(-1, -2) @ (
            beta[:, t, :, None, None] * (v[:, t, :, None, :] - kt @ st))
        st = st * torch.exp(g[:, t])[..., None]
        o.append((q[:, t, :, None, :] * d ** -0.5 @ st)[:, :, 0])
    return torch.stack(o, 1), st


def test_the_checks_catch_the_decay_after_the_update(monkeypatch):
    from repro_torch.kernels import ref

    monkeypatch.setattr(ref, "kda_scan_ref", _decay_after_update)
    checks = {ch.name: ch for ch in _checks()}
    assert not checks["feature_gap"].ok, checks


def test_the_checks_catch_absent_experts_pairs_computed(monkeypatch):
    """Every pair computed, the absent experts' on held weights (ids
    modulo the share): another card's part of the result added here."""
    from repro_torch.models import moe

    real = moe.held_experts

    def every_pair(x, topv, local, load, w_up, w_down, w_gate, count):
        # the count of every pair, read here, not the held pairs' count
        n = w_up.shape[0]
        return real(x, topv, local % n, moe.expert_load(local % n, n), w_up,
                    w_down, w_gate)

    monkeypatch.setattr(moe, "held_experts", every_pair)
    checks = {ch.name: ch for ch in _checks()}
    assert not checks["feature_gap"].ok, checks
