"""The Nemotron-H cell's pieces on the CPU at a small size: the
benchmark's reference against the repo's tests' copy, the weights drawn
by (seed, name) alike into the program and for the reference, and the
forward's operations a token by hand."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tests")]

from perfbench import harness  # noqa: E402
from perfbench.data import nemotron_weights, survival_text  # noqa: E402
from perfbench.reference import nemotron_h  # noqa: E402

BIG = 2 ** 31 + 4242
# the configuration file at a small size: every kind of layer once
SMALL = {
    "num_hidden_layers": 5, "hybrid_override_pattern": "MEM*E",
    "hidden_size": 64, "vocab_size": 300, "mamba_num_heads": 6,
    "mamba_head_dim": 16, "n_groups": 2, "ssm_state_size": 16,
    "chunk_size": 16, "n_routed_experts": 8, "num_experts_per_tok": 2,
    "moe_intermediate_size": 128, "moe_shared_expert_intermediate_size": 256,
    "num_attention_heads": 8, "num_key_value_heads": 2, "head_dim": 16,
    "dtype": "float32"}


def _config():
    cfg = harness.load_json(harness.HERE / "configs"
                            / "nemotron3-nano-30b-a3b.json")
    cfg.update(SMALL)
    return cfg


def test_reference_against_the_tests_copy():
    import reference_nemotron_h as tests_ref

    cfg = _config()
    toks = torch.as_tensor(survival_text.batch(BIG, 0, 3, 48, 300))
    draw = lambda name: nemotron_weights.draw(cfg, BIG, name, "cpu")
    got = nemotron_h.features(draw, toks, cfg)
    want = tests_ref.features(draw, toks, cfg)
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))
    fp8 = nemotron_h.features(draw, toks, cfg, matmul=nemotron_h.fp8_matmul)
    assert not torch.allclose(fp8[0], got[0], rtol=1e-3, atol=1e-4)
    # replayed at the float8 run's choices: both copies report one gap
    again = [nemotron_h.features(draw, toks, cfg, routes=fp8[2]),
             tests_ref.features(draw, toks, cfg, routes=fp8[2])]
    assert again[0][3] == again[1][3] > 0.0
    torch.testing.assert_close(again[0][0], again[1][0], rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_drawn_alike_for_the_program_and_the_reference(dtype):
    from repro_torch.models import build_model

    from perfbench.drivers import featurize_nemotron

    cfg = {**_config(), "dtype": dtype}
    model = build_model(featurize_nemotron.model_config(cfg), device="cpu")
    head = nemotron_weights.fill(model, cfg, BIG)
    params = dict(model.named_parameters())
    assert set(params) == set(nemotron_weights.spec(cfg))
    for name, p in params.items():
        assert torch.equal(p.detach(), nemotron_weights.draw(cfg, BIG, name,
                                                             "cpu")), name
    assert torch.equal(head["cox_head.w"], params["cox_head.w"].detach())
    assert params["layers.1.moe.router_bias"].dtype == torch.float32
    assert params["layers.1.moe.w_up"].dtype == getattr(torch, dtype)
    # another seed or another name, another tensor
    other = nemotron_weights.draw(cfg, BIG + 1, "layers.1.moe.w_up", "cpu")
    assert not torch.equal(other, params["layers.1.moe.w_up"].detach())
    assert not torch.equal(params["layers.0.ln.scale"],
                           params["layers.2.ln.scale"])


def test_forward_flops_by_hand():
    d, di, gn, n, h = 64, 96, 32, 16, 6
    m = (2 * d * (2 * di + 2 * gn + h)     # in projection: 33,536
         + 2 * 4 * (di + 2 * gn)           # conv: 1,280
         + 5 * di * n                      # SSD recurrence: 7,680
         + 8 * di                          # skip, gate, gated norm
         + 2 * di * d                      # out projection: 12,288
         + 4 * d)                          # layer norm
    e = (2 * d * 8                         # router
         + 2 * (4 * d * 128 + 2 * 128)     # two relu^2 experts
         + 4 * d * 256 + 2 * 256           # the shared expert
         + 4 * d)
    s = 32
    a = (2 * d * (8 + 2 * 2) * 16          # q, k, v
         + 2 * 8 * 16 * (s + 1)            # causal scores and values
         + 2 * 8 * 16 * d                  # out projection
         + 4 * d)
    assert (m, e, a) == (55_808, 133_376, 49_664)
    want = 2 * m + 2 * e + a + 5 * d
    assert want == 428_352
    got = harness.roofline("nemotron_h_forward").flops_per_token(_config(), s)
    assert got == want
